"""The fused band kernel (Pallas, Triton route) in interpret mode, against
the oracles; its gradient rule against the XLA band route's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from blur_algorithms import oracle
from blur_algorithms.ops.band_matmul import blur_band_matmul
from blur_algorithms.ops.plan import make_custom_plan, make_plan
from blur_algorithms.pallas_kernels import fused_band as fb

SHARPEN = np.array([-0.25, 1.5, -0.25], np.float32)
TENT = np.array([0.25, 0.5, 0.25], np.float32)


def _tiling(plan, in_bytes):
    h, w = plan.shape
    return fb.pick_tiling(
        plan.col.support_radius, plan.row.support_radius, h, w, in_bytes
    )


def _u8_want(img, plan):
    return np.clip(np.floor(oracle.blur_direct(img, plan) + 0.5), 0, 255)


PLANS = {
    "gauss_small": lambda s: make_plan(s, 1.0),
    "gauss_mid": lambda s: make_plan(s, 3.5),
    "gauss_wide": lambda s: make_plan(s, 9.0),
    "aniso": lambda s: make_plan(s, (4.0, 1.5)),
    "row_radius0": lambda s: make_plan(s, (3.0, 0.2)),
    "col_radius0": lambda s: make_plan(s, (0.2, 3.0)),
    "box_fast": lambda s: make_plan(s, 2, kernel="box_fast", box_passes=2),
    "tent_custom": lambda s: make_custom_plan(s, TENT, np.ones(5, np.float32) / 5),
}
SHAPES = {
    "odd": (37, 53),
    "non_pow2": (48, 100),
    "below_tile": (9, 11),
    "tall": (70, 20),
}


@pytest.mark.parametrize("shape", list(SHAPES), ids=list(SHAPES))
@pytest.mark.parametrize("kind", list(PLANS), ids=list(PLANS))
def test_u8_matches_oracle(rng, kind, shape):
    hw = SHAPES[shape]
    plan = PLANS[kind](hw)
    img = (rng.random((2,) + hw) * 255).astype(np.uint8)
    got = np.asarray(fb.blur_fused_band_u8(jnp.asarray(img), plan,
                                           _tiling(plan, 1), interpret=True))
    assert got.dtype == np.uint8 and got.shape == img.shape
    d = np.abs(got.astype(int) - _u8_want(img, plan).astype(int))
    assert d.max() <= 1
    if kind != "tent_custom":  # quarter-weight taps land on .5 ties often
        assert (d == 0).mean() > 0.99


@pytest.mark.parametrize("kind", ["gauss_mid", "aniso", "col_radius0"])
@pytest.mark.parametrize("shape", ["odd", "below_tile"])
def test_float_matches_oracle(rng, kind, shape):
    hw = SHAPES[shape]
    plan = PLANS[kind](hw)
    x = rng.random((3,) + hw).astype(np.float32) * 255
    got = np.asarray(fb.blur_fused_band(jnp.asarray(x), plan,
                                        _tiling(plan, 4), True))
    np.testing.assert_allclose(got, oracle.blur_direct(x, plan), atol=1e-2)


def test_signed_custom_taps(rng):
    plan = make_custom_plan((40, 52), SHARPEN, np.array([-0.1, 1.2, -0.1], np.float32))
    img = (rng.random((3, 40, 52)) * 255).astype(np.uint8)
    got = np.asarray(fb.blur_fused_band_u8(jnp.asarray(img), plan,
                                           _tiling(plan, 1), interpret=True))
    d = np.abs(got.astype(int) - _u8_want(img, plan).astype(int))
    assert d.max() <= 1


def test_asymmetric_taps_keep_correlation_orientation(rng):
    taps = np.array([0.0, 0.0, 1.0], np.float32)  # out[j] = in[j + 1]
    plan = make_custom_plan((24, 40), taps, np.array([1.0], np.float32))
    x = rng.random((24, 40)).astype(np.float32) * 255
    got = np.asarray(fb.blur_fused_band(jnp.asarray(x), plan,
                                        _tiling(plan, 4), True))
    np.testing.assert_allclose(got, oracle.blur_direct(x, plan), atol=1e-2)


@pytest.mark.parametrize("lead", [(), (3,), (2, 3)])
def test_batch_and_single_frame(rng, lead):
    plan = make_plan((30, 44), 2.5)
    img = (rng.random(lead + (30, 44)) * 255).astype(np.uint8)
    got = np.asarray(fb.blur_fused_band_u8(jnp.asarray(img), plan,
                                           _tiling(plan, 1), interpret=True))
    assert got.shape == img.shape
    d = np.abs(got.astype(int) - _u8_want(img, plan).astype(int))
    assert d.max() <= 1


def test_constant_frame_is_exact():
    plan = make_plan((33, 47), 4.0)
    img = np.full((3, 33, 47), 173, np.uint8)
    got = np.asarray(fb.blur_fused_band_u8(jnp.asarray(img), plan,
                                           _tiling(plan, 1), interpret=True))
    np.testing.assert_array_equal(got, img)


@pytest.mark.parametrize("t", [
    fb.Tiling(16, 16, 16, 0, 0),
    fb.Tiling(32, 16, 32, 0, 0),
    fb.Tiling(16, 32, 64, 0, 0),
])
def test_any_valid_tiling_gives_the_same_blur(rng, t):
    """Tiles, chunks and windows change the schedule, not the result."""
    plan = make_plan((45, 61), 3.0)
    r = plan.row.support_radius
    t = fb.Tiling(t.th, t.tw, t.kc, -(-(t.th + 2 * r) // t.kc),
                  fb._next_pow2(t.tw + 2 * r))
    img = (rng.random((2, 45, 61)) * 255).astype(np.uint8)
    base = fb.blur_fused_band_u8(jnp.asarray(img), plan, _tiling(plan, 1),
                                 interpret=True)
    got = fb.blur_fused_band_u8(jnp.asarray(img), plan, t, interpret=True)
    d = np.abs(np.asarray(got).astype(int) - np.asarray(base).astype(int))
    assert d.max() <= 1 and (d == 0).mean() > 0.999


def test_pre_padded_rows(rng):
    """Halo rows supplied by the caller stand in for the row reflection."""
    from blur_algorithms.ops.pad import reflect_101

    plan = make_plan((28, 36), 2.0)
    rh = plan.col.support_radius
    img = (rng.random((3, 28, 36)) * 255).astype(np.uint8)
    haloed = reflect_101(jnp.asarray(img), [(rh, rh)], axes=[-2])
    got = fb.fused_band_call(haloed, plan, _tiling(plan, 1), True,
                             pre_padded_col=True, interpret=True)
    d = np.abs(np.asarray(got).astype(int) - _u8_want(img, plan).astype(int))
    assert d.max() <= 1


@pytest.mark.parametrize("sigma", [1.5, (3.0, 1.0), 6.0])
def test_vjp_matches_xla_band_route(rng, sigma):
    """The kernel's custom_vjp (the adjoint operator) equals autodiff
    through the XLA band route."""
    plan = make_plan((24, 40), sigma)
    t = _tiling(plan, 4)
    x = jnp.asarray(rng.random((2, 24, 40)).astype(np.float32))
    ct = jnp.asarray(rng.random((2, 24, 40)).astype(np.float32))
    _, vjp_k = jax.vjp(lambda v: fb.blur_fused_band(v, plan, t, True), x)
    _, vjp_b = jax.vjp(
        lambda v: blur_band_matmul(v, plan, jax.lax.Precision.HIGHEST), x)
    np.testing.assert_allclose(
        np.asarray(vjp_k(ct)[0]), np.asarray(vjp_b(ct)[0]), atol=1e-5)


def test_grad_of_scalar_loss(rng):
    plan = make_plan((16, 20), 1.5)
    t = _tiling(plan, 4)
    x = jnp.asarray(rng.random((16, 20)).astype(np.float32))
    g = jax.grad(lambda v: jnp.sum(fb.blur_fused_band(v, plan, t, True) ** 2))(x)
    ref = jax.grad(lambda v: jnp.sum(
        blur_band_matmul(v, plan, jax.lax.Precision.HIGHEST) ** 2))(x)
    np.testing.assert_allclose(np.asarray(g), np.asarray(ref), atol=1e-4)
