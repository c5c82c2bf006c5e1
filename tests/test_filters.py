"""Composite filters (unsharp mask, high-pass) vs numpy oracles."""

import jax.numpy as jnp
import numpy as np
import pytest

from blur_algorithms import oracle
from blur_algorithms.models import high_pass, unsharp_mask
from blur_algorithms.ops.plan import make_plan


def _oracle_unsharp(img_hwc: np.ndarray, sigma: float, amount: float,
                    threshold: int = 0) -> np.ndarray:
    plan = make_plan(img_hwc.shape[:2], sigma)
    x = np.moveaxis(img_hwc, -1, 0).astype(np.float64)
    low = oracle.blur_direct(x, plan)
    detail = x - low
    if threshold:
        detail = np.where(np.abs(detail) >= threshold, detail, 0.0)
    out = np.clip(np.floor(x + amount * detail + 0.5), 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, -1)


class TestUnsharpMask:
    def test_u8_matches_oracle(self, rgb_image):
        got = np.asarray(unsharp_mask(jnp.asarray(rgb_image), 2.0, 0.8))
        want = _oracle_unsharp(rgb_image, 2.0, 0.8)
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1

    def test_threshold_variant(self, rgb_image):
        got = np.asarray(
            unsharp_mask(jnp.asarray(rgb_image), 2.0, 1.5, threshold=8)
        )
        want = _oracle_unsharp(rgb_image, 2.0, 1.5, threshold=8)
        # the threshold's hard cutoff can flip a pixel whose |detail| sits on
        # the boundary within float error; allow a tiny flip fraction
        diff = np.abs(got.astype(int) - want.astype(int))
        assert (diff > 1).mean() < 1e-3
        assert diff.max() <= 255 * 1.5 * 0.02 + 2  # only boundary flips

    def test_amount_zero_is_identity(self, rgb_image):
        got = np.asarray(unsharp_mask(jnp.asarray(rgb_image), 3.0, 0.0))
        np.testing.assert_array_equal(got, rgb_image)

    def test_float_planar(self, rng):
        x = (rng.random((2, 40, 48)) * 255).astype(np.float32)
        got = np.asarray(unsharp_mask(jnp.asarray(x), 2.0, 1.0))
        plan = make_plan((40, 48), 2.0)
        want = 2 * x.astype(np.float64) - oracle.blur_direct(x, plan)
        np.testing.assert_allclose(got, want, atol=5e-2)

    def test_u8_requires_interleaved(self):
        with pytest.raises(ValueError, match="interleaved"):
            unsharp_mask(jnp.zeros((16, 16), jnp.uint8), 2.0)


class TestHighPass:
    def test_u8_residual(self, rgb_image):
        got = np.asarray(high_pass(jnp.asarray(rgb_image), 4.0))
        plan = make_plan(rgb_image.shape[:2], 4.0)
        x = np.moveaxis(rgb_image, -1, 0).astype(np.float64)
        want = x - oracle.blur_direct(x, plan)
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, want, atol=5e-2)

    def test_high_plus_low_reconstructs(self, rng):
        x = (rng.random((1, 32, 40)) * 255).astype(np.float32)
        hp = np.asarray(high_pass(jnp.asarray(x), 3.0))
        plan = make_plan((32, 40), 3.0)
        low = oracle.blur_direct(x, plan)
        np.testing.assert_allclose(hp + low, x, atol=5e-2)
