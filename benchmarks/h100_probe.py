"""Kernel-vs-XLA, tiling and crossover probe on one GPU.

Measures, on 2160x3840 RGB uint8 frames (one JSON line per measurement, on
stdout and in ``--out``):

1. the fused band kernel against the plain XLA band route at batch 4,
   sigma=10, both end to end on interleaved frames and checked against the
   oracle — the measurement that decides whether the kernel stays;
2. a tiling sweep of the kernel at support radius 32..128 beside the XLA
   band route — the data behind ``fused_band._TILINGS`` and its reach;
3. band routes against the FFT routes (``jnp.fft``, and ``fft_mxu``'s
   matmul DFT at the wide radii) on one frame at radius 64..2048 — the
   AUTO crossovers in ``utils/hw.py``;
4. box blur through the fused engine against the cumsum scan.

Run on the card from the repository root:

    python benchmarks/h100_probe.py --out chiprun_out/h100_probe.jsonl
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

H, W, BATCH, SIGMA = 2160, 3840, 4, 10.0
SWEEP_RADII = (32, 48, 64, 96, 128)
CROSS_RADII = (64, 112, 128, 192, 256, 1024, 2048)


def sigma_for_radius(r: int) -> float:
    """Smallest sigma (to 0.01) whose planned support radius is ``r``."""
    from blur_algorithms.ops.plan import make_plan

    s = (r + 1) / 3.33
    while make_plan((4 * r + 8, 4 * r + 8), s).row.support_radius < r:
        s += 0.01
    return s


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="chiprun_out/h100_probe.jsonl")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from blur_algorithms import api, box_blur, oracle
    from blur_algorithms.ops import band_matmul, fft_conv, fft_mxu
    from blur_algorithms.ops.box_blur import box_blur_scan_u8
    from blur_algorithms.ops.layout import round_to_u8
    from blur_algorithms.ops.plan import make_plan
    from blur_algorithms.pallas_kernels import fused_band as fb
    from blur_algorithms.utils.timing import time_fn

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    dev = jax.devices()[0]
    print(card)
    print(f"platform={dev.platform} kind={dev.device_kind} count={len(jax.devices())}")
    if dev.platform != "gpu":
        print("no GPU", file=sys.stderr)
        return 1
    log = open(args.out, "w")

    def emit(**rec):
        rec["card"] = card
        line = json.dumps(rec)
        print(line, flush=True)
        log.write(line + "\n")
        log.flush()

    def measure(name, fn, x, **extra):
        try:
            t0 = time.perf_counter()
            out = jax.block_until_ready(fn(x))
            first_s = time.perf_counter() - t0
            r = time_fn(fn, x, iters=20, warmup=2)
            emit(name=name, ms=r.median_ms, min_ms=r.min_ms,
                 first_call_s=first_s, **extra)
            return out
        except Exception as exc:  # noqa: BLE001 — a probe records failures
            emit(name=name, error=f"{type(exc).__name__}: {str(exc)[:600]}",
                 **extra)
            return None

    def planar(f):
        return jax.jit(lambda v: jnp.moveaxis(f(jnp.moveaxis(v, -1, -3)), -3, -1))

    def xla_band(plan, precision):
        return lambda p: round_to_u8(
            band_matmul.blur_band_matmul(p.astype(jnp.float32), plan, precision))

    rng = np.random.default_rng(0)
    frames = rng.integers(0, 256, (BATCH, H, W, 3), dtype=np.uint8)
    x = jnp.asarray(frames)
    x1 = x[0]

    # 1. the headline config, end to end
    plan = make_plan((H, W), SIGMA)
    r0 = plan.row.support_radius
    t0 = fb.pick_tiling(r0, r0, H, W, 1)
    want0 = oracle.blur_u8(frames[0], SIGMA)
    routes = {
        "kernel": planar(lambda p: fb.blur_fused_band_u8(p, plan, t0)),
        "xla_band_bf16x3": planar(xla_band(plan, "bf16x3")),
        "xla_band_highest": planar(xla_band(plan, jax.lax.Precision.HIGHEST)),
    }
    for name, fn in routes.items():
        out = measure(f"headline_{name}", fn, x, radius=r0, tiling=str(t0))
        if out is not None:
            d = np.abs(np.asarray(out[0]).astype(int) - want0.astype(int))
            emit(name=f"headline_{name}_err", max_err=int(d.max()),
                 exact=float((d == 0).mean()))

    # 2. tiling sweep (batch 4 at radius 32, one frame above)
    for r in SWEEP_RADII:
        p = plan if r == r0 else make_plan((H, W), sigma_for_radius(r))
        xs = x if r == r0 else x1
        ref = measure("sweep_xla_band_bf16x3", planar(xla_band(p, "bf16x3")),
                      xs, radius=r)
        for th in (32, 64, 128):
            for tw in (32, 64, 128):
                for kc in (32, 64):
                    for warps in (4, 8):
                        if th * tw > 64 * 128 or (warps == 8 and th * tw < 4096):
                            continue
                        t = fb.Tiling(th, tw, kc, -(-(th + 2 * r) // kc),
                                      fb._next_pow2(tw + 2 * r), warps, 2)
                        if fb.smem_bytes(t, 1) > 227 * 1024:
                            continue
                        out = measure(
                            "sweep_kernel",
                            planar(lambda q, p=p, t=t: fb.blur_fused_band_u8(q, p, t)),
                            xs, radius=r, tiling=str(t))
                        if out is not None and ref is not None:
                            d = np.abs(np.asarray(out).astype(int)
                                       - np.asarray(ref).astype(int)).max()
                            if d > 1:
                                emit(name="sweep_mismatch", radius=r,
                                     tiling=str(t), max_diff=int(d))

    # 3. band vs FFT on one frame
    for r in CROSS_RADII:
        p = make_plan((H, W), sigma_for_radius(r))
        t = fb.pick_tiling(r, r, H, W, 1)
        if t is not None:
            measure("cross_kernel", planar(lambda q, p=p, t=t: fb.blur_fused_band_u8(q, p, t)),
                    x1, radius=r, tiling=str(t))
        for prec in ("bf16x3", jax.lax.Precision.HIGHEST):
            measure(f"cross_xla_band_{'highest' if prec != 'bf16x3' else prec}",
                    planar(xla_band(p, prec)), x1, radius=r)
        measure("cross_fft_tiles", planar(lambda q, p=p: round_to_u8(
            fft_conv.blur_fft_tiles(q.astype(jnp.float32), p))), x1, radius=r)
        if r >= 1024:
            measure("cross_fft_mxu_highest", planar(lambda q, p=p: round_to_u8(
                fft_mxu.blur_fft_mxu(q.astype(jnp.float32), p,
                                     precision=jax.lax.Precision.HIGHEST))),
                    x1, radius=r)

    # 4. box: folded taps through the fused engine vs the cumsum scan
    for n in (2.0, 3.0, 5.0, 7.0, 8.0):
        radius = int(n * n)
        p = make_plan((H, W), radius, kernel="box_fast", box_passes=2)
        measure("box_fused", jax.jit(api._fused_u8_interleaved(p)), x1,
                support_radius=p.row.support_radius)
        measure("box_scan", planar(lambda q, radius=radius: box_blur_scan_u8(q, radius)),
                x1, support_radius=p.row.support_radius)
        measure("box_blur_auto", lambda v, n=n: box_blur(v, n), x1,
                support_radius=p.row.support_radius)
    log.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
