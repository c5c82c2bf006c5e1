"""Kernel factory parity with the reference math (Source.cpp:60-140)."""

import math

import numpy as np
import pytest

from blur_algorithms.ops import kernels


class TestGaussianWindow:
    def test_reference_formula(self):
        # width = trunc(2*(sigma*sqrt(2 ln 255) - 1) + .5), forced odd
        for sigma in [0.5, 1.0, 2.0, 5.0, 10.0, 31.4, 50.0, 100.0]:
            radius = np.float32(sigma * math.sqrt(2 * math.log(255)) - 1)
            expect = int(np.float32(radius * 2 + np.float32(0.5)))
            if expect % 2 == 0:
                expect += 1
            assert kernels.gaussian_window(sigma) == max(expect, 1)

    def test_clamped_to_max_width(self):
        w = kernels.gaussian_window(1000.0, max_width=257)
        assert w == 257
        # clamp then force odd (reference order: min first, then ++ if even)
        w = kernels.gaussian_window(1000.0, max_width=256)
        assert w == 257

    def test_always_odd_and_positive(self):
        for sigma in np.linspace(0.1, 60, 113):
            w = kernels.gaussian_window(float(sigma))
            assert w >= 1 and w % 2 == 1

    def test_sigma_10(self):
        # sigma=10: radius = 10*3.3302... - 1 = 32.302 -> width 65
        assert kernels.gaussian_window(10.0) == 65


class TestGaussianKernel:
    def test_normalized_symmetric(self):
        for sigma, width in [(2.0, 13), (10.0, 65), (0.8, 5)]:
            k = kernels.gaussian_kernel(sigma, width)
            assert k.dtype == np.float32
            assert abs(float(np.sum(k, dtype=np.float64)) - 1.0) < 1e-6
            np.testing.assert_allclose(k, k[::-1], rtol=0, atol=1e-9)
            assert np.argmax(k) == width // 2

    def test_matches_reference_sampling(self):
        sigma, width = 3.0, 19
        k = kernels.gaussian_kernel(sigma, width)
        mid = (width - 1) / 2.0
        s = 2.0 * sigma * sigma
        raw = np.array(
            [math.exp(-((y - mid) ** 2) / s) / (math.pi * s) for y in range(width)],
            dtype=np.float32,
        )
        expect = raw / raw.astype(np.float64).sum()
        np.testing.assert_allclose(k, expect.astype(np.float32), atol=2e-7)

    def test_rejects_even_width(self):
        with pytest.raises(ValueError):
            kernels.gaussian_kernel(2.0, 6)


class TestBoxTent:
    def test_taps(self):
        k = kernels.box_tent_kernel(3)
        # (3-|i|)/9 for i in [-2..2]
        np.testing.assert_allclose(k, np.array([1, 2, 3, 2, 1]) / 9.0, atol=1e-7)
        assert abs(k.sum() - 1.0) < 1e-6

    def test_box_convolved_with_itself(self):
        for n in [2, 5, 8]:
            box = np.ones(n) / n
            tent = np.convolve(box, box)
            np.testing.assert_allclose(kernels.box_tent_kernel(n), tent, atol=1e-7)


class TestWrapCentered:
    def test_center_lands_at_zero(self):
        taps = np.array([0.1, 0.2, 0.4, 0.2, 0.1], dtype=np.float32)
        w = kernels.wrap_centered(taps, 8)
        # rotate by width//2=2: [0.4, 0.2, 0.1, 0, 0, 0, 0.1, 0.2]
        np.testing.assert_allclose(
            w, [0.4, 0.2, 0.1, 0, 0, 0, 0.1, 0.2], atol=1e-7
        )

    def test_width_equals_fft_length(self):
        taps = kernels.gaussian_kernel(2.0, 9)
        w = kernels.wrap_centered(taps, 9)
        assert w[0] == taps[4]

    def test_spectrum_is_purely_real(self):
        # A centered symmetric kernel has zero imaginary spectrum
        taps = kernels.gaussian_kernel(5.0, 33)
        wrapped = kernels.wrap_centered(taps, 96)
        spec = np.fft.rfft(wrapped)
        assert np.max(np.abs(spec.imag)) < 1e-7

    def test_real_spectrum_dc_is_one(self):
        taps = kernels.gaussian_kernel(4.0, 27)
        spec = kernels.real_spectrum(taps, 64)
        assert abs(spec[0] - 1.0) < 1e-6  # normalized kernel: DC gain 1
        assert spec.shape == (33,)
