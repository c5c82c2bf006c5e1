"""Cascade engine: semigroup decomposition accuracy and step selection."""

import math

import jax.numpy as jnp
import numpy as np
import pytest

from blur_algorithms import Engine, blur_u8, oracle
from blur_algorithms.ops.cascade import blur_cascade, cascade_sigmas


def test_sigma_split_preserves_variance():
    for sigma in [10.0, 155.0, 700.0, 2000.0]:
        steps = cascade_sigmas(sigma)
        total = math.sqrt(sum(s * s for s in steps))
        assert abs(total - sigma) < 1e-9
        assert all(s <= 1203 for s in steps) or len(steps) == 1


def test_fused_reach_single_step():
    # the exact fused engine covers radius <= ~4000 in one (split) pass, so
    # the cascade only decomposes beyond sigma ~ 1200
    assert len(cascade_sigmas(10.0)) == 1
    assert len(cascade_sigmas(1200.0)) == 1
    assert len(cascade_sigmas(1300.0)) >= 2
    assert len(cascade_sigmas(2400.0)) >= 4


def test_cascade_close_to_exact_blur(rng):
    # force a multi-step split on a small image by lowering the step cap:
    # per-axis clamps kick in for both paths, compare against the exact
    # oracle loosely
    from blur_algorithms.ops import cascade as cascade_mod
    from blur_algorithms.ops.plan import make_plan

    x = rng.random((300, 280)).astype(np.float32) * 255
    sigma = 80.0
    old = cascade_mod._STEP_MAX_RADIUS
    cascade_mod._STEP_MAX_RADIUS = 224
    try:
        assert len(cascade_sigmas(sigma)) >= 2
        got = np.asarray(blur_cascade(jnp.asarray(x), sigma))
    finally:
        cascade_mod._STEP_MAX_RADIUS = old
    want = oracle.blur_direct(x, make_plan((300, 280), sigma))
    # approximation: a few counts of deviation allowed, structure preserved
    assert np.abs(got - want).max() < 4.0
    assert np.abs(got - want).mean() < 1.0


def test_cascade_u8_api(rng):
    img = (rng.random((128, 128, 3)) * 255).astype(np.uint8)
    out = np.asarray(blur_u8(jnp.asarray(img), 90.0, engine=Engine.CASCADE))
    assert out.shape == img.shape and out.dtype == np.uint8
    assert out.std() < img.std() / 2


def test_too_large_sigma_raises():
    with pytest.raises(ValueError):
        cascade_sigmas(1e6)
