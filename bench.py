"""Headline benchmark: batch-4 4K RGB Gaussian blur, sigma=10, uint8 in/out.

Runs ``blur_u8`` with AUTO routing on the default device and prints ONE
JSON line:

  {"metric": ..., "value": MP/s, "unit": "MP/s", "vs_baseline": x,
   "device": {...}, ...}

vs_baseline is against the reference's best engine (pffft, 1-D tiles) at its
closest published size: 4000x2500 in 46.92 ms = 213.2 MP/s on an M3 Pro
12-core CPU (BASELINE.md; py/performance.ipynb pffft[5]).

Each step is fenced with ``block_until_ready`` (``utils/timing.time_fn``).
Accuracy gate: max abs uint8 error vs the CPU pocketfft oracle on frame 0
must be <= 1. Without a GPU the script fails: a CPU timing is no
measurement of this system.
"""

from __future__ import annotations

import json
import subprocess
import sys

import numpy as np

REF_MP_PER_S = 4000 * 2500 / 1e6 / (46.92 / 1e3)  # 213.15 MP/s

H, W, BATCH, SIGMA = 2160, 3840, 4, 10.0


def make_frames(batch: int, h: int, w: int) -> np.ndarray:
    """Structured synthetic RGB frames (sinusoids + noise, per-frame phase),
    interleaved ``(B, H, W, 3)`` uint8."""
    rng = np.random.default_rng(42)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    frames = []
    for b in range(batch):
        base = (
            127
            + 70 * np.sin(xx / (11.0 + b) + b)
            + 50 * np.cos(yy / (17.0 + 2 * b))
            + rng.normal(0, 18, (h, w)).astype(np.float32)
        )
        img = np.stack(
            [base, np.roll(base, 31, axis=0), np.roll(base, 17, axis=1)], axis=-1
        )
        frames.append(np.clip(img, 0, 255).astype(np.uint8))
    return np.stack(frames)


def main() -> int:
    import jax
    import jax.numpy as jnp

    from blur_algorithms.utils.cache import enable_persistent_cache

    enable_persistent_cache()

    from blur_algorithms import api, oracle
    from blur_algorithms.utils.timing import time_fn

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"no GPU found (platform {dev.platform!r})", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()

    frames = make_frames(BATCH, H, W)
    x = jnp.asarray(frames)
    plan, engine = api._plan_for(
        H, W, SIGMA, api.Engine.AUTO, "gaussian", "auto",
        lead=BATCH * frames.shape[-1],
    )

    def step(v):
        return api.blur_u8(v, SIGMA)

    result = time_fn(step, x, iters=50, warmup=3, megapixels=BATCH * H * W / 1e6)
    out0 = np.asarray(step(x))[0]
    want = oracle.blur_u8(frames[0], SIGMA)
    diff = np.abs(out0.astype(int) - want.astype(int))
    max_err = int(diff.max())

    value = result.mpix_per_s
    print(
        json.dumps(
            {
                "metric": "megapixels/sec, batch-4 4K RGB Gaussian blur "
                "(sigma=10), uint8 in/out",
                "value": value,
                "unit": "MP/s",
                "vs_baseline": value / REF_MP_PER_S,
                "max_abs_err_u8": max_err,
                "exact_fraction": float((diff == 0).mean()),
                "per_step_ms": result.median_ms,
                "engine": engine.value,
                "config": f"batch{BATCH} {W}x{H} RGB, radius "
                f"{plan.row.support_radius}",
                "card": card,
                "device": {
                    "platform": dev.platform,
                    "kind": dev.device_kind,
                    "count": len(jax.devices()),
                },
            }
        )
    )
    return 0 if max_err <= 1 else 1


if __name__ == "__main__":
    sys.exit(main())
