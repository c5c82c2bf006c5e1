"""Many sigmas, one compiled dispatch: the sigma sweep as a batch axis.

The reference's sweep workflows (the benchmark loop ``Source.cpp:628-634``
and the ``DFT_image`` radius sweeps behind ``test_images/spectrum_analysis``)
re-run the full pipeline per sigma — here that would also mean one XLA
compile per sigma, since the kernel width changes the pad geometry. This
module makes the sigma axis a BATCH axis of a single program instead:

* geometry (pad, borders, FFT lengths) comes from the LARGEST sigma; a
  reflect-101 pad wider than a kernel's radius is exact for that kernel
  (its window never reaches past the correctly mirrored region), so every
  sigma shares one padded frame;
* per-sigma kernel spectra are stacked into an ``(N, bins)`` constant per
  axis (the reference's per-sigma ``getGaussian`` loop, vectorized);
* the forward 2-D rFFT of the frame is computed ONCE and broadcast over
  the sigma axis — only the spectral multiply and the inverse transform
  pay per sigma. Cost ~ (1 + N) / (2 N) of N separate blurs, with exactly
  one compile.

Same math as the ``fft2`` engine (``Source.cpp:143-277``); parity vs the
per-sigma oracle is tested in ``tests/test_multi_sigma.py``.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from blur_algorithms.ops import kernels
from blur_algorithms.ops.fft_conv import _mirror_full, rfft2_pipeline
from blur_algorithms.ops.plan import clamped_axis_width, make_plan

__all__ = ["blur_multi_sigma", "blur_multi_sigma_u8"]


def _sigma_tuple(sigmas) -> tuple[float, ...]:
    sig = tuple(float(s) for s in np.atleast_1d(np.asarray(sigmas)))
    if not sig:
        raise ValueError("sigmas must be a non-empty sequence of floats")
    return sig


def _sigma_spectra(
    sigmas: tuple[float, ...], shape: tuple[int, int],
    fft_h: int, fft_w: int
) -> tuple[np.ndarray, np.ndarray]:
    """Stacked real spectra: cols ``(N, fft_h)`` full, rows ``(N, hw)`` half.

    Taps follow each sigma's own plan exactly (reference width formula +
    per-axis ``pad <= dim - 1`` clamp + renormalization — the same
    ``clamped_axis_width``/``gaussian_kernel`` calls ``make_plan`` makes),
    but are wrapped into the SHARED transform lengths of the widest
    kernel's geometry, so no per-sigma plan (with its own throwaway FFT
    lengths and spectra) is built.
    """
    h, w = shape
    cols = np.empty((len(sigmas), fft_h), np.float32)
    rows = np.empty((len(sigmas), fft_w // 2 + 1), np.float32)
    for i, s in enumerate(sigmas):
        if s <= 0.0:
            cols[i] = 1.0  # identity: radius-0 kernel
            rows[i] = 1.0
            continue
        gw = kernels.gaussian_window(s, max(h, w))
        col_taps = kernels.gaussian_kernel(s, clamped_axis_width(h, gw))
        row_taps = kernels.gaussian_kernel(s, clamped_axis_width(w, gw))
        cols[i] = _mirror_full(kernels.real_spectrum(col_taps, fft_h), fft_h)
        rows[i] = kernels.real_spectrum(row_taps, fft_w)
    return cols, rows


@functools.lru_cache(maxsize=64)
def _compiled_multi(
    shape: tuple[int, ...], sigmas: tuple[float, ...], size_mode: str,
    out_u8: bool,
):
    h, w = shape[-2], shape[-1]
    # geometry of the widest kernel serves every sigma exactly
    plan = make_plan((h, w), max(max(sigmas), 0.1), size_mode=size_mode)
    fft_h, fft_w = plan.fft_shape
    cols, rows = _sigma_spectra(sigmas, (h, w), fft_h, fft_w)

    def fn(planar):
        planar = planar.astype(jnp.float32)
        # sigma batch axis in front; keep the two 1-D spectra as separate
        # broadcasts (XLA fuses them — materializing the (N, fft_h, hw)
        # outer product would bake a giant constant, see fft_conv.blur_fft2)
        lead = (1,) * (planar.ndim - 2)
        n = len(sigmas)
        ck = jnp.asarray(cols).reshape((n,) + lead + (fft_h, 1))
        rk = jnp.asarray(rows).reshape((n,) + lead + (1, fft_w // 2 + 1))
        out = rfft2_pipeline(planar, plan, lambda spec: spec[None] * ck * rk)
        if out_u8:
            from blur_algorithms.ops.layout import round_to_u8

            return round_to_u8(out)
        return out

    return jax.jit(fn)


def blur_multi_sigma(
    planar: jnp.ndarray, sigmas, size_mode: str = "auto"
) -> jnp.ndarray:
    """Gaussian-blur ``(..., H, W)`` float planar data at N sigmas at once.

    Returns ``(N, ..., H, W)`` float32 — the sigma sweep stacked in front.
    One compile per (shape, sigmas, size_mode); the frame's forward FFT is
    shared across the whole sweep. Each slice matches ``blur(x, sigma_i,
    engine="fft2")`` (and the CPU oracle) exactly.
    """
    sig = _sigma_tuple(sigmas)
    fn = _compiled_multi(tuple(planar.shape), sig, size_mode, False)
    return fn(jnp.asarray(planar))


def blur_multi_sigma_u8(
    img: jnp.ndarray, sigmas, size_mode: str = "auto"
) -> jnp.ndarray:
    """uint8 interleaved ``(..., H, W, C)`` -> uint8 ``(N, ..., H, W, C)``."""
    img = jnp.asarray(img)
    if img.dtype != jnp.uint8:
        raise TypeError(f"blur_multi_sigma_u8 expects uint8, got {img.dtype}")
    from blur_algorithms.ops import layout

    sig = _sigma_tuple(sigmas)
    planar = layout.to_planar(img)
    fn = _compiled_multi(tuple(planar.shape), sig, size_mode, True)
    return jnp.moveaxis(fn(planar), -3, -1)
