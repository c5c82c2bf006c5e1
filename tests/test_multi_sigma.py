"""blur_multi_sigma: N sigmas as one dispatch, per-slice oracle parity."""

import numpy as np
import pytest

from blur_algorithms import oracle
from blur_algorithms.ops.multi_sigma import (
    _compiled_multi,
    blur_multi_sigma,
    blur_multi_sigma_u8,
)
from blur_algorithms.ops.plan import make_plan


@pytest.fixture(scope="module")
def frame():
    rng = np.random.default_rng(11)
    return (rng.random((3, 72, 88)) * 255).astype(np.float32)


def test_each_slice_matches_oracle(frame):
    sigmas = [0.8, 4.0, 11.0]
    out = np.asarray(blur_multi_sigma(frame, sigmas))
    assert out.shape == (3,) + frame.shape
    for i, s in enumerate(sigmas):
        plan = make_plan(frame.shape[-2:], s)
        want = oracle.blur_planar_fft2(frame, plan)
        np.testing.assert_allclose(out[i], want, atol=2e-2)


def test_zero_sigma_is_identity(frame):
    out = np.asarray(blur_multi_sigma(frame, [0.0, 2.0]))
    np.testing.assert_allclose(out[0], frame, atol=1e-3)


def test_extreme_sigma_clamped_axis(frame):
    # radius clamps against the short axis: taps renormalize per axis
    sigmas = [30.0]
    out = np.asarray(blur_multi_sigma(frame, sigmas))
    plan = make_plan(frame.shape[-2:], 30.0)
    want = oracle.blur_planar_fft2(frame, plan)
    np.testing.assert_allclose(out[0], want, atol=2e-2)


def test_u8_matches_oracle(rgb_image):
    sigmas = [1.5, 6.0]
    out = np.asarray(blur_multi_sigma_u8(rgb_image, sigmas))
    assert out.shape == (2,) + rgb_image.shape
    for i, s in enumerate(sigmas):
        want = oracle.blur_u8(rgb_image, s)
        d = np.abs(out[i].astype(int) - want.astype(int))
        assert d.max() <= 1


def test_empty_sigmas_rejected(frame):
    with pytest.raises(ValueError, match="non-empty"):
        blur_multi_sigma(frame, [])


def test_single_compile_per_sweep(frame):
    _compiled_multi.cache_clear()
    blur_multi_sigma(frame, [1.0, 2.0, 3.0, 4.0])
    assert _compiled_multi.cache_info().misses == 1
    blur_multi_sigma(frame, [1.0, 2.0, 3.0, 4.0])
    assert _compiled_multi.cache_info().hits == 1
