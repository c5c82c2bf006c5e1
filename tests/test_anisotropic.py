"""Anisotropic Gaussian: ``nsmooth=(sigma_y, sigma_x)`` through the API.

Beyond the reference (single-sigma only): each axis plans its own
width/taps/spectrum, so every taps/spectra-driven engine serves the plan
unchanged. Independent oracles: the naive direct convolution built from
the plan's own per-axis taps, and cv::GaussianBlur's sigmaX/sigmaY form.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from blur_algorithms import Engine, blur, blur_u8, oracle
from blur_algorithms.ops.plan import make_plan


@pytest.fixture
def rng():
    return np.random.default_rng(11)


def test_plan_per_axis_geometry():
    plan = make_plan((64, 96), (3.0, 9.0))
    assert plan.sigma == 3.0 and plan.sigma_x == 9.0
    assert plan.col.support_radius < plan.row.support_radius
    # each axis's taps are exactly that sigma's isotropic taps
    iso_y = make_plan((64, 96), 3.0)
    iso_x = make_plan((64, 96), 9.0)
    np.testing.assert_array_equal(plan.col.taps, iso_y.col.taps)
    np.testing.assert_array_equal(plan.row.taps, iso_x.row.taps)


def test_equal_pair_collapses_to_isotropic():
    plan = make_plan((32, 32), (4.0, 4.0))
    assert plan.sigma_x is None
    assert plan.sigma == 4.0


def test_engines_match_direct_oracle(rng):
    x = (rng.random((1, 48, 80)) * 255).astype(np.float32)
    plan = make_plan((48, 80), (2.0, 6.0))
    want = oracle.blur_direct(x, plan)
    for eng in [Engine.FFT2, Engine.FFT_TILES, Engine.CONV, Engine.BAND,
                Engine.FUSED]:
        got = np.asarray(blur(jnp.asarray(x), (2.0, 6.0), engine=eng))
        np.testing.assert_allclose(got, want, atol=2e-2, err_msg=str(eng))


def test_u8_auto_matches_oracle(rng):
    img = (rng.random((40, 56, 3)) * 255).astype(np.uint8)
    got = np.asarray(blur_u8(jnp.asarray(img), (5.0, 1.5)))
    want = oracle.blur_u8(img, (5.0, 1.5))
    d = np.abs(got.astype(int) - want.astype(int))
    assert d.max() <= 1
    assert (d == 0).mean() > 0.98


def test_opencv_anisotropic_parity(rng):
    cv2 = pytest.importorskip("cv2")
    from blur_algorithms.ops.kernels import gaussian_window

    img = (rng.random((72, 64, 3)) * 255).astype(np.uint8)
    sy, sx = 2.0, 7.0
    wy = gaussian_window(sy, 72)
    wx = gaussian_window(sx, 72)
    ours = np.asarray(blur_u8(jnp.asarray(img), (sy, sx)))
    ref = cv2.GaussianBlur(
        img, (wx, wy), sigmaX=sx, sigmaY=sy,
        borderType=cv2.BORDER_REFLECT_101,
    )
    diff = np.abs(ours.astype(int) - ref.astype(int))
    assert diff.max() <= 2
    assert (diff <= 1).mean() > 0.99


def test_scalar_only_engines_reject_pairs(rng):
    img = (rng.random((16, 16, 3)) * 255).astype(np.uint8)
    x = jnp.asarray(img)
    with pytest.raises(ValueError):
        blur_u8(x, (2.0, 3.0), engine=Engine.DERICHE)
    with pytest.raises(ValueError):
        blur_u8(x, (2.0, 3.0), engine=Engine.CASCADE)
    with pytest.raises(ValueError):
        blur_u8(x, (2.0, 3.0), engine=Engine.BOX)
    with pytest.raises(ValueError):
        make_plan((16, 16), (2.0, 3.0), kernel="box")
    with pytest.raises(ValueError):
        make_plan((16, 16), (2.0, 3.0, 4.0))
    with pytest.raises(ValueError):
        make_plan((16, 16), (2.0, -1.0))
