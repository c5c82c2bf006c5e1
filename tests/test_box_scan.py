"""The cumsum-difference box engine (``box_scan``) + routing."""

import jax.numpy as jnp
import numpy as np

from blur_algorithms import Engine, blur_u8, oracle
from blur_algorithms.api import _plan_for
from blur_algorithms.ops.box_blur import (
    box_blur_scan,
    box_blur_scan_axis,
    box_blur_scan_u8,
)


def _naive_box_axis(x, r, axis):
    xm = np.moveaxis(x.astype(np.float64), axis, -1)
    n = xm.shape[-1]
    padded = oracle.reflect_101_np(xm, [(r, r)])
    out = np.zeros_like(xm)
    for t in range(2 * r + 1):
        out += padded[..., t : t + n]
    return np.moveaxis(out / (2 * r + 1), -1, axis)


def test_single_pass_matches_naive(rng):
    x = rng.random((2, 24, 40)).astype(np.float32) * 255
    got = np.asarray(box_blur_scan_axis(jnp.asarray(x), 5, passes=1))
    np.testing.assert_allclose(got, _naive_box_axis(x, 5, -1), atol=1e-2)


def test_two_passes_both_axes(rng):
    x = rng.random((3, 30, 26)).astype(np.float32) * 255
    got = np.asarray(box_blur_scan(jnp.asarray(x), 3, passes=2))
    want = x.astype(np.float64)
    for _ in range(2):
        want = _naive_box_axis(want, 3, -1)
    for _ in range(2):
        want = _naive_box_axis(want, 3, -2)
    np.testing.assert_allclose(got, want, atol=1e-2)


def test_zero_radius_identity(rng):
    x = rng.random((8, 9)).astype(np.float32)
    np.testing.assert_allclose(np.asarray(box_blur_scan(jnp.asarray(x), 0)), x)


def test_radius_clamped_to_axis(rng):
    x = rng.random((2, 6, 300)).astype(np.float32)
    out = np.asarray(box_blur_scan(jnp.asarray(x), 50, passes=2))
    assert out.shape == x.shape
    assert np.isfinite(out).all()


def test_auto_routing_small_radius_uses_matmul_engines():
    plan, eng = _plan_for(512, 512, 4.0, Engine.BOX, "gaussian", "smooth235")
    assert eng in (Engine.FUSED, Engine.BAND)
    assert plan.kernel == "box_fast"


def test_auto_routing_huge_radius_uses_scan():
    # nsmooth=30 -> radius 900 -> folded support radius 1800 -> scan engine
    plan, eng = _plan_for(4096, 4096, 30.0, Engine.BOX, "gaussian", "smooth235")
    assert eng is Engine.BOX_SCAN


def test_box_scan_u8_end_to_end(rng):
    img = (rng.random((64, 80, 3)) * 255).astype(np.uint8)
    got = np.asarray(blur_u8(jnp.asarray(img), 2.0, engine=Engine.BOX_SCAN))
    want_f = _naive_box_axis(
        _naive_box_axis(
            _naive_box_axis(
                _naive_box_axis(
                    np.moveaxis(img, -1, 0).astype(np.float64), 4, -1
                ),
                4,
                -1,
            ),
            4,
            -2,
        ),
        4,
        -2,
    )
    want = np.clip(np.floor(np.moveaxis(want_f, 0, -1) + 0.5), 0, 255).astype(int)
    assert np.abs(got.astype(int) - want).max() <= 1


def test_box_scan_u8_kernel_end_to_end(rng):
    """box_blur_scan_u8: u8 in / u8 out == float path + reference round."""

    x = (rng.random((3, 40, 56)) * 255).astype(np.uint8)
    got = np.asarray(box_blur_scan_u8(jnp.asarray(x), 4, passes=2))
    assert got.dtype == np.uint8
    want_f = np.asarray(
        box_blur_scan(jnp.asarray(x).astype(jnp.float32), 4, passes=2)
    )
    want = np.clip(np.floor(want_f + 0.5), 0, 255).astype(np.uint8)
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1 and (diff == 0).mean() > 0.999


def test_box_scan_u8_zero_radius(rng):

    x = (rng.random((2, 16, 16)) * 255).astype(np.uint8)
    np.testing.assert_array_equal(
        np.asarray(box_blur_scan_u8(jnp.asarray(x), 0)), x
    )
