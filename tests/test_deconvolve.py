"""Wiener deconvolution: spectral exactness + blur round-trip recovery."""

import numpy as np
import pytest

from blur_algorithms import blur
from blur_algorithms.models.deconvolve import wiener_deconvolve
from blur_algorithms.ops.fft_conv import _mirror_full
from blur_algorithms.ops.pad import reflect_101
from blur_algorithms.ops.plan import make_plan


@pytest.fixture(scope="module")
def smooth_frame():
    # band-limited content: recovery is well-posed away from crushed bins
    yy, xx = np.mgrid[0:80, 0:96].astype(np.float32)
    base = (
        127
        + 50 * np.sin(xx / 9.0)
        + 40 * np.cos(yy / 12.0)
        # mid-frequency components (period ~6-8 px): attenuated ~7x by a
        # sigma=2 blur yet still recoverable (H well above the balance)
        + 25 * np.sin(xx * 1.0)
        + 15 * np.cos(yy * 0.8)
    )
    return np.stack([base, np.roll(base, 7, 0)], axis=0)


def test_matches_numpy_wiener(smooth_frame):
    sigma, balance = 3.0, 1e-3
    got = np.asarray(wiener_deconvolve(smooth_frame, sigma, balance))
    plan = make_plan(smooth_frame.shape[-2:], sigma)
    (bt, bb), (bl, br) = plan.col.border, plan.row.border
    fft_h, fft_w = plan.fft_shape
    padded = np.asarray(
        reflect_101(smooth_frame.astype(np.float32), [(bt, bb), (bl, br)])
    )
    spec = np.fft.rfft2(padded, axes=(-2, -1))
    h2d = (
        _mirror_full(plan.col.spectrum, fft_h)[:, None]
        * plan.row.spectrum[None, :]
    )
    spec *= h2d / (h2d * h2d + balance)
    want = np.fft.irfft2(spec, s=(fft_h, fft_w), axes=(-2, -1))[
        ..., bt : bt + 80, bl : bl + 96
    ]
    np.testing.assert_allclose(got, want, atol=1e-2)


def test_roundtrip_recovers_interior(smooth_frame):
    # the forward crop + re-pad breaks exact circularity, so tiny balance
    # amplifies the border mismatch — 1e-3 is the practical regime
    sigma = 2.0
    blurred = np.asarray(blur(smooth_frame, sigma, engine="fft2"))
    recovered = np.asarray(wiener_deconvolve(blurred, sigma, balance=1e-3))
    interior = (slice(None), slice(12, -12), slice(12, -12))
    err = np.abs(recovered[interior] - smooth_frame[interior])
    assert err.max() < 2.0  # counts on a 0..255 scale
    blur_err = np.abs(blurred[interior] - smooth_frame[interior])
    assert err.max() < 0.2 * blur_err.max()


def test_u8_path(smooth_frame):
    # band-limited content: a noisy image's high bins are crushed by the
    # blur and are not recoverable by ANY deconvolver
    img = np.clip(
        np.stack([smooth_frame[0]] * 3, axis=-1), 0, 255
    ).astype(np.uint8)
    sigma = 2.0
    blurred = np.asarray(
        blur(np.moveaxis(img, -1, 0).astype(np.float32), sigma, engine="fft2")
    )
    blurred_u8 = np.moveaxis(
        np.clip(np.floor(blurred + 0.5), 0, 255).astype(np.uint8), 0, -1
    )
    out = np.asarray(wiener_deconvolve(blurred_u8, sigma, balance=1e-3))
    assert out.shape == img.shape and out.dtype == np.uint8
    interior = (slice(12, -12), slice(12, -12), slice(None))
    err = np.abs(out[interior].astype(int) - img[interior].astype(int))
    blur_err = np.abs(
        blurred_u8[interior].astype(int) - img[interior].astype(int)
    )
    assert np.median(err) <= 2
    assert err.mean() < 0.35 * blur_err.mean()


def test_rejects_asymmetric_kernel(monkeypatch):
    # unreachable via the public kernel names today; the guard protects
    # against future kernel kinds with complex spectra
    import dataclasses

    import blur_algorithms.models.deconvolve as dc

    real = dc.make_plan

    def asymmetric(shape, nsmooth, **kw):
        p = real(shape, nsmooth, **kw)
        row = dataclasses.replace(p.row, spectrum_c=np.zeros(3, np.complex64))
        return dataclasses.replace(p, row=row)

    monkeypatch.setattr(dc, "make_plan", asymmetric)
    dc._compiled_wiener.cache_clear()
    with pytest.raises(ValueError, match="symmetric"):
        dc._compiled_wiener((2, 32, 32), 2.0, 1e-3, "gaussian", "auto", False)
    dc._compiled_wiener.cache_clear()
