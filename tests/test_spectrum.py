"""DFT_image spectrum-export mode (Source.cpp:240-252)."""

import jax.numpy as jnp
import numpy as np

from blur_algorithms import dft_spectrum, oracle
from blur_algorithms.ops.plan import make_plan


def test_matches_numpy_oracle(rng):
    x = rng.random((2, 40, 48)).astype(np.float32) * 255
    plan = make_plan((40, 48), 2.0)
    want = oracle.dft_spectrum_np(x, plan)
    got = np.asarray(dft_spectrum(jnp.asarray(x), 2.0))
    np.testing.assert_allclose(got, want, atol=1e-2)


def test_uint8_channel_api(rgb_image):
    spec = np.asarray(dft_spectrum(jnp.asarray(rgb_image), 1.0))
    plan = make_plan(rgb_image.shape[:2], 1.0)
    assert spec.shape == (3,) + plan.fft_shape
    assert np.isfinite(spec).all()


def test_dc_dominates_at_center(rng):
    # after fftshift the DC bin sits at (s0+?)//2 per the reference's
    # odd/even convention; for a positive image it is the max of the map
    x = rng.random((32, 32)).astype(np.float32) * 255 + 1
    plan = make_plan((32, 32), 1.0)
    spec = oracle.dft_spectrum_np(x, plan)
    s0, s1 = plan.fft_shape
    assert spec.argmax() == (s0 // 2) * s1 + (s1 // 2)


def test_blur_attenuates_high_frequencies(rgb_image):
    """The reference's spectrum-analysis sweep in test image form: blurring
    must lower off-center (high-frequency) energy."""
    from blur_algorithms import blur_u8

    sharp = np.asarray(dft_spectrum(jnp.asarray(rgb_image), 1.0))
    blurred_img = blur_u8(jnp.asarray(rgb_image), 6.0)
    blurred = np.asarray(dft_spectrum(blurred_img, 1.0))
    s0, s1 = sharp.shape[-2:]
    # compare mean log-magnitude outside the central quarter
    mask = np.ones((s0, s1), bool)
    mask[s0 // 2 - s0 // 8 : s0 // 2 + s0 // 8, s1 // 2 - s1 // 8 : s1 // 2 + s1 // 8] = (
        False
    )
    assert blurred[..., mask].mean() < sharp[..., mask].mean() - 5.0
