"""End-to-end check of the blur main path on NVIDIA GPUs.

Run from the repository root on a machine with a GPU:

    python chip_smoke.py            # one card: phases 1-7 below
    python chip_smoke.py --multi    # four cards: the sharded phase only

It drives the entry points a user calls (``blur_u8`` / AUTO, ``box_blur``,
``blur``, the HTTP server of ``examples/serve.py``, ``parallel/``) at the
sizes users run, with frames made on the device from a seed, and compares
every result with the CPU oracle (``blur_algorithms/oracle.py``): at
most 1 uint8 count on the u8 paths. It makes no speed claim; the times it
prints name the card. Without a GPU it exits non-zero and prints no
result. Its last line is one JSON object naming the device.

Phases (one card):
  1. blur_u8 AUTO, batch 4, 2160x3840 RGB, sigma=10: route, compile
     seconds, memory analysis, peak memory, ms/step, error vs the oracle.
  2. The fused band kernel against the plain XLA band route at that config.
  3. Wide radius on one 4K frame, sigma 150 and 600 (radius ~500 and
     ~2000, both routed to the FFT on an H100).
  4. The reference's largest point, 24000x14500 RGB, sigma=sqrt(24000):
     a corner and an interior (512+2r)^2 patch against the oracle.
  5. box_blur at 4K: nsmooth=3, and one radius that routes box_scan.
  6. The served path: POST 1080p and 4K PPM frames at sigma 3 and 10; each
     reply equals blur_u8 on the same frame.
  7. jax.grad through blur on a 512x512 float frame against the gradient
     of the XLA band route.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import os
import subprocess
import sys
import threading
import time
import traceback
import urllib.request

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
HEADLINE = dict(batch=4, h=2160, w=3840, sigma=10.0)


def say(*args) -> None:
    print(*args, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


def frames_u8(seed: int, shape: tuple[int, ...]):
    """Random uint8 frames made on the default device."""
    import jax
    import jax.numpy as jnp

    key = jax.random.PRNGKey(seed)
    return jax.random.randint(key, shape, 0, 256, dtype=jnp.int32).astype(
        jnp.uint8
    )


def err_u8(got, want) -> tuple[int, float]:
    """(max abs error, exact fraction) of two uint8 arrays."""
    d = np.abs(np.asarray(got).astype(np.int32) - np.asarray(want).astype(np.int32))
    return int(d.max()), float((d == 0).mean())


def gate(name: str, max_err: int, limit: int = 1) -> None:
    if max_err > limit:
        raise AssertionError(f"{name}: max error {max_err} > {limit}")


def route_of(h: int, w: int, sigma, lead: int, kernel: str = "gaussian") -> str:
    """The route AUTO takes for one frame shape, as a readable string."""
    from blur_algorithms import api
    from blur_algorithms.ops import fused

    engine = api.Engine.BOX if kernel == "box_fast" else api.Engine.AUTO
    plan, eng = api._plan_for(h, w, sigma, engine, "gaussian", "auto", lead=lead)
    r = max(plan.row.support_radius, plan.col.support_radius)
    if eng is api.Engine.FUSED:
        t = fused.kernel_tiling(plan, 1)
        via = f"kernel {t}" if t is not None else "xla band"
        return f"fused ({via}), radius {r}"
    return f"{eng.value}, radius {r}"


def ms_per_step(fn, *args, iters: int = 20) -> float:
    from blur_algorithms.utils.timing import time_fn

    return time_fn(fn, *args, iters=iters, warmup=2).median_ms


def peak_bytes() -> int:
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    return int(stats.get("peak_bytes_in_use", -1))


# --- checks (tests/test_gpu.py calls them at smaller sizes) -----------------


def check_headline(batch: int, h: int, w: int, sigma: float) -> dict:
    """blur_u8 AUTO on a batch; frame 0 against the oracle."""
    from blur_algorithms import api, oracle

    x = frames_u8(0, (batch, h, w, 3))
    fn = api._compiled_u8(tuple(x.shape), sigma, api.Engine.AUTO, "gaussian", "auto")
    t0 = time.perf_counter()
    compiled = fn.lower(x).compile()
    compile_s = time.perf_counter() - t0
    ma = compiled.memory_analysis()
    out = api.blur_u8(x, sigma)
    e, exact = err_u8(out[0], oracle.blur_u8(np.asarray(x[0]), sigma))
    gate("headline", e)
    return {
        "route": route_of(h, w, sigma, batch * 3),
        "compile_s": compile_s,
        "memory_analysis": {
            k: getattr(ma, k) for k in (
                "argument_size_in_bytes", "output_size_in_bytes",
                "temp_size_in_bytes", "generated_code_size_in_bytes",
            )
        },
        "ms_per_step": ms_per_step(lambda v: api.blur_u8(v, sigma), x, iters=50),
        "megapixels": batch * h * w / 1e6,
        "peak_bytes_in_use": peak_bytes(),
        "max_err": e,
        "exact_fraction": exact,
    }


def check_kernel_vs_xla(batch: int, h: int, w: int, sigma: float) -> dict:
    """The fused band kernel and the plain XLA band route, both end to end
    on interleaved frames, both against the oracle."""
    import jax
    import jax.numpy as jnp

    from blur_algorithms import oracle
    from blur_algorithms.ops import band_matmul, fused
    from blur_algorithms.ops.layout import round_to_u8
    from blur_algorithms.ops.plan import make_plan
    from blur_algorithms.pallas_kernels import fused_band

    plan = make_plan((h, w), sigma)
    t = fused.kernel_tiling(plan, 1)
    if t is None:
        raise AssertionError(f"the kernel does not serve radius {plan.row.support_radius}")

    def planar(f):
        return jax.jit(lambda v: jnp.moveaxis(f(jnp.moveaxis(v, -1, -3)), -3, -1))

    routes = {
        "kernel": planar(lambda p: fused_band.blur_fused_band_u8(p, plan, t)),
        "xla_band_bf16x3": planar(lambda p: round_to_u8(
            band_matmul.blur_band_matmul(p.astype(jnp.float32), plan, "bf16x3"))),
    }
    x = frames_u8(1, (batch, h, w, 3))
    want = oracle.blur_u8(np.asarray(x[0]), sigma)
    res = {"tiling": str(t)}
    for name, fn in routes.items():
        e, exact = err_u8(fn(x)[0], want)
        gate(name, e)
        res[name] = {"ms_per_step": ms_per_step(fn, x, iters=50),
                     "max_err": e, "exact_fraction": exact}
    return res


def check_wide(h: int, w: int, sigmas: tuple[float, ...]) -> dict:
    """Wide radii on one frame through AUTO, against the oracle."""
    from blur_algorithms import api, oracle

    x = frames_u8(2, (h, w, 3))
    host = np.asarray(x)
    res = {}
    for s in sigmas:
        out = api.blur_u8(x, s)
        e, exact = err_u8(out, oracle.blur_u8(host, s))
        gate(f"sigma {s}", e)
        res[f"sigma={s}"] = {
            "route": route_of(h, w, s, 3),
            "ms_per_step": ms_per_step(lambda v, s=s: api.blur_u8(v, s), x),
            "max_err": e, "exact_fraction": exact,
        }
    return res


def check_giant(h: int, w: int, sigma: float, patch: int = 512) -> dict:
    """One giant frame through AUTO; the blur is local (support radius r),
    so a corner and an interior (patch+2r)^2 window of the input, blurred
    by the oracle, must reproduce the frame's output on the inner patch."""
    import jax

    from blur_algorithms import api, oracle
    from blur_algorithms.ops.plan import make_plan

    r = make_plan((h, w), sigma).row.support_radius
    x = frames_u8(3, (h, w, 3))
    t0 = time.perf_counter()
    out = jax.block_until_ready(api.blur_u8(x, sigma))
    first_s = time.perf_counter() - t0
    res = {"route": route_of(h, w, sigma, 3), "radius": r,
           "first_call_s": first_s,
           "ms_per_step": ms_per_step(lambda v: api.blur_u8(v, sigma), x, iters=5),
           "peak_bytes_in_use": peak_bytes()}
    span = patch + 2 * r
    cy, cx = h // 2, w // 2
    windows = {
        "corner": ((0, 0), (0, 0)),
        "interior": ((cy - patch // 2 - r, cx - patch // 2 - r), (r, r)),
    }
    for name, ((y0, x0), (oy, ox)) in windows.items():
        src = np.asarray(x[y0 : y0 + span, x0 : x0 + span])
        want = oracle.blur_u8(src, sigma)[oy : oy + patch, ox : ox + patch]
        got = out[y0 + oy : y0 + oy + patch, x0 + ox : x0 + ox + patch]
        e, exact = err_u8(got, want)
        gate(f"giant {name}", e)
        res[name] = {"max_err": e, "exact_fraction": exact}
    return res


def check_box(h: int, w: int, nsmooths: tuple[float, ...], patch: int = 512) -> dict:
    """box_blur through AUTO; a corner patch against the direct oracle."""
    from blur_algorithms import api, box_blur, oracle
    from blur_algorithms.ops.plan import make_plan

    x = frames_u8(4, (h, w, 3))
    res = {}
    for n in nsmooths:
        radius = int(n * n)
        plan = make_plan((h, w), radius, kernel="box_fast", box_passes=2)
        r = plan.row.support_radius
        span = patch + 2 * r
        src = np.moveaxis(np.asarray(x[:span, :span]), -1, 0)
        pplan = make_plan((span, span), radius, kernel="box_fast", box_passes=2)
        want = np.clip(np.floor(oracle.blur_direct(src, pplan) + 0.5), 0, 255)
        out = box_blur(x, n)
        e, exact = err_u8(out[:patch, :patch], np.moveaxis(want, 0, -1)[:patch, :patch])
        gate(f"box nsmooth {n}", e)
        _, eng = api._plan_for(h, w, n, api.Engine.BOX, "gaussian", "auto")
        res[f"nsmooth={n}"] = {
            "route": f"{eng.value}, support radius {r}",
            "ms_per_step": ms_per_step(lambda v, n=n: box_blur(v, n), x),
            "max_err": e, "exact_fraction": exact,
        }
    return res


def check_served(shapes: tuple[tuple[int, int], ...], sigmas: tuple[float, ...],
                 warm: int = 3) -> dict:
    """The HTTP server of examples/serve.py in this process: each reply
    equals blur_u8 on the same frame; client-side latencies."""
    import jax.numpy as jnp

    from blur_algorithms import blur_u8
    from blur_algorithms.utils.io import decode_image, encode_image

    spec = importlib.util.spec_from_file_location(
        "serve", os.path.join(ROOT, "examples", "serve.py")
    )
    serve = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(serve)
    httpd = serve.serve(port=0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    port = httpd.server_address[1]
    res = {}
    try:
        for i, (h, w) in enumerate(shapes):
            img = np.asarray(frames_u8(10 + i, (h, w, 3)))
            body = encode_image(img, "ppm")
            for s in sigmas:
                lat = []
                for _ in range(1 + warm):
                    req = urllib.request.Request(
                        f"http://127.0.0.1:{port}/blur?sigma={s}&format=ppm",
                        data=body, method="POST",
                    )
                    t0 = time.perf_counter()
                    with urllib.request.urlopen(req, timeout=600) as resp:
                        reply = resp.read()
                    lat.append((time.perf_counter() - t0) * 1e3)
                got = decode_image(reply, "ppm")
                want = np.asarray(blur_u8(jnp.asarray(img), s))
                if not np.array_equal(got, want):
                    e, _ = err_u8(got, want)
                    raise AssertionError(
                        f"served {h}x{w} sigma {s} differs from blur_u8 "
                        f"(max {e})"
                    )
                res[f"{h}x{w} sigma={s}"] = {
                    "cold_ms": lat[0], "warm_ms": lat[1:],
                }
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
    return res


def check_grad(h: int, w: int, sigma: float) -> dict:
    """jax.grad through blur (the fused engine) against autodiff through the
    XLA band route at full float32 precision."""
    import jax
    import jax.numpy as jnp

    from blur_algorithms import blur
    from blur_algorithms.ops import band_matmul, fused
    from blur_algorithms.ops.plan import make_plan

    plan = make_plan((h, w), sigma)
    key1, key2 = jax.random.split(jax.random.PRNGKey(5))
    x = jax.random.uniform(key1, (3, h, w), jnp.float32) * 255.0
    ct = jax.random.normal(key2, (3, h, w), jnp.float32)

    def band(v):
        return band_matmul.blur_band_matmul(v, plan, jax.lax.Precision.HIGHEST)

    g = jax.grad(lambda v: jnp.vdot(blur(v, sigma), ct))(x)
    g_ref = jax.grad(lambda v: jnp.vdot(band(v), ct))(x)
    scale = float(jnp.max(jnp.abs(g_ref)))
    g_err = float(jnp.max(jnp.abs(g - g_ref)))
    fwd_err = float(jnp.max(jnp.abs(blur(x, sigma) - band(x))))
    if g_err > 1e-4 * scale:
        raise AssertionError(f"gradient differs by {g_err} (scale {scale})")
    if fwd_err > 1e-2:
        raise AssertionError(f"forward differs by {fwd_err}")
    t = fused.kernel_tiling(plan, 4)
    return {"route": f"kernel {t}" if t is not None else "xla band",
            "grad_max_abs_diff": g_err, "grad_scale": scale,
            "forward_max_abs_diff": fwd_err}


def check_multi(batch: int, h: int, w: int, big: tuple[int, int],
                sigmas: tuple[float, ...], patch: int = 256) -> dict:
    """The sharded paths over every visible device, each against the
    single-device result and an oracle patch."""
    import jax
    import jax.numpy as jnp

    from blur_algorithms import api, oracle
    from blur_algorithms.ops.plan import make_plan
    from blur_algorithms.parallel import (
        blur_fft_sharded_u8,
        blur_sharded_u8,
        make_mesh,
    )

    n = len(jax.devices())
    res = {"devices": n}

    def single(img, s):
        """One device, the route AUTO would take there (explicit engines
        never shard)."""
        hh, ww = img.shape[-3], img.shape[-2]
        _, eng = api._plan_for(hh, ww, s, api.Engine.AUTO, "gaussian", "auto",
                               lead=math.prod(img.shape[:-3]) * 3)
        img = jax.device_put(img, jax.devices()[0])
        return api.blur_u8(img, s, engine=eng)

    def compare(name, got, ref, src, s):
        e_ref, exact = err_u8(got, ref)
        r = make_plan(src.shape[:2], s).row.support_radius
        span = patch + 2 * r
        want = oracle.blur_u8(np.asarray(src[:span, :span]), s)[:patch, :patch]
        e_or, _ = err_u8(got[:patch, :patch], want)
        gate(f"{name} vs single device", e_ref)
        gate(f"{name} vs oracle", e_or)
        return {"max_err_vs_single": e_ref, "exact_vs_single": exact,
                "max_err_vs_oracle_patch": e_or}

    xb = frames_u8(20, (batch, h, w, 3))
    s0 = sigmas[0]
    ref_b = single(xb, s0)
    mesh_dp = make_mesh(dp=n, sp=1)
    plan_b = make_plan((h, w), s0)  # plans are jit keys by identity: one
    out = blur_sharded_u8(xb, plan_b, mesh_dp)
    res[f"dp={n} batch {batch} {h}x{w} sigma={s0}"] = {
        **compare("dp", out[0], ref_b[0], np.asarray(xb[0]), s0),
        "ms_sharded": ms_per_step(
            lambda v: blur_sharded_u8(v, plan_b, mesh_dp), xb),
        "ms_single": ms_per_step(lambda v: single(v, s0), xb),
    }
    fn = api._compiled_u8(tuple(xb.shape), s0, api.Engine.AUTO, "gaussian", "auto")
    if not getattr(fn, "_sharded", False):
        raise AssertionError("AUTO did not shard the batch")
    res["AUTO batch"] = {
        **compare("AUTO batch", api.blur_u8(xb, s0)[0], ref_b[0],
                  np.asarray(xb[0]), s0),
        "ms": ms_per_step(lambda v: api.blur_u8(v, s0), xb),
    }
    del xb, ref_b

    # the single-frame size from which row sharding pays (auto_sp_min_px)
    mesh_sp = make_mesh(dp=1, sp=n)
    for fh, fw in ((1080, 1920), (h, w)):
        xf = frames_u8(22, (fh, fw, 3))
        plan = make_plan((fh, fw), s0)
        res[f"sp={n} vs one device {fh}x{fw} sigma={s0}"] = {
            "ms_sharded": ms_per_step(
                lambda v, p=plan: blur_sharded_u8(v[None], p, mesh_sp)[0], xf),
            "ms_single": ms_per_step(lambda v: single(v, s0), xf),
        }

    bh, bw = big
    xs = frames_u8(21, (bh, bw, 3))
    src = np.asarray(xs[: patch + 2 * 600, : patch + 2 * 600])
    for s in sigmas:
        plan = make_plan((bh, bw), s)
        ref = single(xs, s)
        got = blur_sharded_u8(xs[None], plan, mesh_sp)[0]
        res[f"sp={n} {bh}x{bw} sigma={s}"] = {
            **compare(f"sp sigma {s}", got, ref, src, s),
            "route": route_of(bh, bw, s, 3),
            "ms_sharded": ms_per_step(
                lambda v, p=plan: blur_sharded_u8(v[None], p, mesh_sp)[0], xs),
            "ms_single": ms_per_step(lambda v, s=s: single(v, s), xs),
        }
    plan = make_plan((bh, bw), s0)
    got = blur_fft_sharded_u8(xs[None], plan, mesh_sp)[0]
    res[f"fft sp={n} {bh}x{bw} sigma={s0}"] = {
        **compare("fft sharded", got, single(xs, s0), src, s0),
        "ms_sharded": ms_per_step(
            lambda v: blur_fft_sharded_u8(v[None], plan, mesh_sp)[0], xs),
    }
    fn = api._compiled_u8(tuple(xs.shape), s0, api.Engine.AUTO, "gaussian", "auto")
    res["AUTO single frame"] = {
        "sharded": bool(getattr(fn, "_sharded", False)),
        **compare("AUTO frame", api.blur_u8(xs, s0), single(xs, s0), src, s0),
        "ms": ms_per_step(lambda v: api.blur_u8(v, s0), xs),
    }
    return res


# --- driver ------------------------------------------------------------------


def setup() -> None:
    from blur_algorithms.utils.cache import enable_persistent_cache

    say(f"compile cache: {enable_persistent_cache()}")
    from blur_algorithms.utils import native

    if not native.available():
        native.build()
    say(f"host path: {'native libblurfx' if native.available() else 'NumPy'}")


def run_phases(phases) -> bool:
    ok = True
    for name, fn in phases:
        t0 = time.perf_counter()
        try:
            res = fn()
            say(json.dumps({"phase": name, "ok": True,
                            "wall_s": time.perf_counter() - t0, **res}, default=str))
        except Exception:  # noqa: BLE001 — every phase runs; any failure fails the run
            ok = False
            say(json.dumps({"phase": name, "ok": False,
                            "wall_s": time.perf_counter() - t0}))
            traceback.print_exc()
            sys.stdout.flush()
    return ok


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the four-card sharded phase")
    args = ap.parse_args()

    say(card_line())
    import jax

    devices = jax.devices()
    dev = devices[0]
    say(f"platform={dev.platform} device_kind={dev.device_kind} count={len(devices)}")
    if dev.platform != "gpu":
        say("no GPU: nothing to check")
        return 2
    if args.multi and len(devices) != 4:
        say(f"--multi needs 4 devices, found {len(devices)}")
        return 2
    setup()
    hl = HEADLINE
    if args.multi:
        phases = [("multi", lambda: check_multi(
            8, hl["h"], hl["w"], (4320, 7680), (10.0, 150.0)))]
    else:
        phases = [
            ("1 headline", lambda: check_headline(**hl)),
            ("2 kernel vs xla", lambda: check_kernel_vs_xla(**hl)),
            ("3 wide radius", lambda: check_wide(hl["h"], hl["w"], (150.0, 600.0))),
            ("4 giant frame", lambda: check_giant(14500, 24000, math.sqrt(24000))),
            ("5 box", lambda: check_box(hl["h"], hl["w"], (3.0, 8.0))),
            ("6 served", lambda: check_served(((1080, 1920), (2160, 3840)), (3.0, 10.0))),
            ("7 grad", lambda: check_grad(512, 512, 10.0)),
        ]
    if not run_phases(phases):
        say("FAILED")
        return 1
    say(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": len(devices),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
