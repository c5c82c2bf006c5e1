"""Seeded fuzz: random (shape, sigma, engine) cases against the oracle.

A cheap randomized safety net on top of the structured parity grids —
odd/even dims, elongated frames, radii at the per-axis clamp, every planar
engine. All cases run on the CPU backend (the same grid runs on any
device through ``benchmarks/parity_grid.py``).
"""

import numpy as np
import pytest

import jax.numpy as jnp

from blur_algorithms import Engine, blur_u8, oracle

ENGINES = [
    Engine.FFT2,
    Engine.FFT_TILES,
    Engine.CONV,
    Engine.BAND,
    Engine.FUSED,
    Engine.FFT_MXU,
]


def _cases(n: int):
    rng = np.random.default_rng(20260816)
    out = []
    for i in range(n):
        h = int(rng.integers(9, 200))
        w = int(rng.integers(9, 200))
        sigma = float(rng.choice([0.7, 1.3, 3.1, 9.9, 27.0, 80.0]))
        eng = ENGINES[int(rng.integers(len(ENGINES)))]
        out.append(pytest.param(h, w, sigma, eng, id=f"{i}:{h}x{w}s{sigma}{eng.value}"))
    return out


@pytest.mark.parametrize("h,w,sigma,eng", _cases(18))
def test_random_case_matches_oracle(h, w, sigma, eng):
    rng = np.random.default_rng(h * 1000 + w)
    img = rng.integers(0, 256, (h, w, 3), np.uint8)
    got = np.asarray(blur_u8(jnp.asarray(img), sigma, engine=eng))
    want = oracle.blur_u8(img, sigma)
    d = np.abs(got.astype(int) - want.astype(int))
    assert d.max() <= 1, f"{eng.value} {h}x{w} sigma={sigma}: max {d.max()}"
