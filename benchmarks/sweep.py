"""Engine benchmark sweep — the reference's benchmark harness.

The reference's published benchmark (``py/performance.ipynb``) sweeps 46
sizes 1500x1000 -> 24000x14500 (x += 500, y += 300) with sigma = sqrt(width)
on an M3 Pro; its commented CLI loop (``Source.cpp:628-634``) uses a finer
x += 225 / y += 150 rule. This reproduces the published methodology on the
default device across this framework's engines, pairs every point with the reference's own
pffft timing for that exact size, and writes JSON (and an optional
matplotlib PNG) for comparison against ``BASELINE.md``.

Usage:
  python benchmarks/sweep.py [--sizes N] [--engines fused band fft2 ...]
                             [--out benchmarks/sweep_results.json] [--plot]
                             [--step notebook|cli]

Timing fences each step with ``block_until_ready`` (utils/timing.py).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def reference_sizes(n: int, step: str = "notebook"):
    x, y = 1500, 1000
    dx, dy = (500, 300) if step == "notebook" else (225, 150)
    out = []
    for _ in range(n):
        out.append((x, y))
        x += dx
        y += dy
    return out


# The reference's own wall-ms per published size, fastest engine (pffft),
# M3 Pro 12 cores: py/performance.ipynb cell 0, `pffft` array (46 entries
# for the notebook size rule above).
REFERENCE_PFFFT_MS = [
    32.05, 11.52, 19.64, 28.31, 39.64, 46.92, 57.19, 79.43, 88.98, 106.69,
    114.97, 141.29, 175.44, 172.12, 224.25, 233.14, 270.86, 378.32, 397.24,
    397.23, 489.47, 433.94, 439.79, 744.96, 516.05, 607.11, 633.42, 705.26,
    716.06, 748.72, 838.16, 873.90, 907.26, 966.44, 963.27, 1127.55,
    1225.35, 1154.47, 1262.71, 1328.17, 1373.25, 1403.04, 1535.46, 1659.44,
    1658.18, 1728.56,
]


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--sizes", type=int, default=12, help="number of sweep sizes")
    p.add_argument("--engines", nargs="+",
                   default=["fused", "band", "fft_tiles", "fft2", "box"])
    p.add_argument("--out", default="benchmarks/sweep_results.json")
    p.add_argument("--plot", action="store_true")
    p.add_argument("--iters", type=int, default=6)
    p.add_argument("--step", choices=["notebook", "cli"], default="notebook")
    args = p.parse_args()

    import jax
    import jax.numpy as jnp

    from blur_algorithms import Engine, blur_u8
    from blur_algorithms.utils.timing import time_fn

    dev = jax.devices()[0]
    print(f"# device: {dev.platform} {dev.device_kind} x{len(jax.devices())}")
    results = []
    for size_i, (x, y) in enumerate(reference_sizes(args.sizes, args.step)):
        sigma = math.sqrt(x)  # reference: sigma = sqrt(width-ish dim)
        # frames are made on the device: host transfers would dominate the
        # set-up at large sizes
        xj = jax.jit(
            lambda k: jax.random.randint(
                k, (x, y, 3), 0, 256, dtype=jnp.int32
            ).astype(jnp.uint8)
        )(jax.random.PRNGKey(x))
        mp = x * y / 1e6
        row = {"h": x, "w": y, "mp": round(mp, 2), "sigma": round(sigma, 2),
               "device": dev.device_kind}
        for name in args.engines:
            eng = Engine(name)
            try:
                r = time_fn(
                    lambda v: blur_u8(v, sigma, engine=eng), xj,
                    iters=args.iters, name=name, megapixels=mp,
                )
                row[name + "_ms"] = round(r.median_ms, 3)
                row[name + "_mps"] = round(r.mpix_per_s, 1)
            except Exception as exc:  # keep sweeping past memory limits
                row[name + "_ms"] = None
                row[name + "_err"] = f"{type(exc).__name__}"
        if args.step == "notebook" and size_i < len(REFERENCE_PFFFT_MS):
            ref = REFERENCE_PFFFT_MS[size_i]
            row["reference_pffft_ms"] = ref
            # compare Gaussian engines only: 'box' computes a different
            # operator than the reference's Gaussian pffft timing
            best = min(
                (row[k] for k in row if k.endswith("_ms") and row[k]
                 and k not in ("reference_pffft_ms", "box_ms")),
                default=None,
            )
            if best:
                row["speedup_vs_reference"] = round(ref / best, 2)
        results.append(row)
        print(json.dumps(row), flush=True)

    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    print(f"wrote {args.out}")

    if args.plot:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        mps = [r["mp"] for r in results]
        plt.figure(figsize=(8, 5))
        for name in args.engines:
            ys = [r.get(name + "_ms") for r in results]
            plt.plot(mps, ys, marker="o", label=name)
        plt.xlabel("megapixels")
        plt.ylabel("ms per frame")
        plt.title(f"engine sweep on {dev.device_kind} (sigma = sqrt(width))")
        plt.legend()
        plt.grid(alpha=0.3)
        png = os.path.splitext(args.out)[0] + ".png"
        plt.savefig(png, dpi=120)
        print(f"wrote {png}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
