"""FFT-convolution blur engines (XLA rFFT, single fused dispatch).

Two engines, mirroring the reference's parity axes as batched XLA FFTs:

* ``blur_fft2``  — the reference ``pocketfft_2D`` path (``Source.cpp:143-277``):
  reflect-101 pad the whole image (pad + FFT growth split across sides),
  one batched 2-D rFFT over all channels/frames, separable pointwise multiply
  by the outer product of the two real 1-D kernel spectra, inverse, crop.

* ``blur_fft_tiles`` — the reference tile engines ``pocketfft_1D`` /
  ``pffft_`` (``Source.cpp:280-392, 429-570``): per-axis 1-D transforms with
  reflected pads and *trailing zeros* for the FFT growth
  (``Source.cpp:297-306``). The reference's per-row ``hybrid_loop`` +
  ``flip_block`` transposes collapse into two batched rFFTs (axis -1, then
  axis -2); XLA owns any layout changes.

Both produce identical interior results in exact arithmetic (the growth
region is never read by cropped outputs); they differ only in execution
strategy and float rounding. Input/output: float32 planar ``(..., H, W)``.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from blur_algorithms.ops.pad import reflect_101
from blur_algorithms.ops.plan import BlurPlan

__all__ = ["blur_fft2", "blur_fft_tiles"]


def _mirror_full(rspec: np.ndarray, n: int) -> np.ndarray:
    """CCS unpack (mirror around Nyquist) — reference ``Source.cpp:215-218``."""
    full = np.zeros(n, dtype=rspec.dtype)
    half = n // 2 + 1
    full[:half] = rspec[:half]
    full[half:] = rspec[1 : n - half + 1][::-1]
    return full


def _mirror_full_c(rspec: np.ndarray, n: int) -> np.ndarray:
    """Complex CCS unpack: upper bins are conjugates of the mirrored lower."""
    full = np.zeros(n, dtype=np.complex64)
    half = n // 2 + 1
    full[:half] = rspec[:half]
    full[half:] = np.conj(rspec[1 : n - half + 1][::-1])
    return full


def _axis_spectrum(axis_plan) -> np.ndarray:
    """Half spectrum for the rows multiply: real (symmetric taps — the
    reference's real-spectrum trick) or complex (asymmetric custom taps)."""
    return axis_plan.spectrum if axis_plan.symmetric else axis_plan.spectrum_c


def _pffft_quirked(spectrum: np.ndarray, fft_len: int) -> np.ndarray:
    """Kernel spectrum with the pffft ordered-layout Nyquist quirk applied.

    pffft's ordered real layout packs DC at ``[0]`` and Nyquist at ``[1]``,
    so the reference's pairwise multiply (both halves of each (re, im) pair
    scaled by ``kernel[2i]``, ``Source.cpp:414-427``) multiplies the data's
    Nyquist bin by the KERNEL'S DC VALUE instead of its true Nyquist value —
    a deliberate accuracy-vs-speed shortcut upstream. Emulated here by
    editing one entry of the kernel-spectrum constant at trace time: the
    rest of the multiply is already mathematically identical.
    """
    if fft_len % 2 != 0:  # odd lengths have no Nyquist bin (never planned)
        return spectrum
    quirked = spectrum.copy()
    quirked[fft_len // 2] = quirked[0]
    return quirked


def rfft2_pipeline(planar: jnp.ndarray, plan: BlurPlan, on_spectrum):
    """Shared 2-D spectral scaffolding: pad, rFFT, transform, irFFT, crop.

    Every 2-D spectral path (the ``fft2`` engine here, the multi-sigma
    sweep, Wiener deconvolution) runs the same border-geometry contract:
    reflect-101 pad by the plan borders, ``rfft2``, a caller-supplied
    ``on_spectrum`` (which may add leading batch axes), ``irfft2`` at the
    planned transform shape, crop the interior. Keeping it in one place
    means a padding-policy change in ``ops/plan.py`` cannot desynchronize
    the spectral paths.
    """
    h, w = plan.shape
    (bt, bb), (bl, br) = plan.col.border, plan.row.border
    fft_h, fft_w = plan.fft_shape
    padded = reflect_101(planar, [(bt, bb), (bl, br)])
    spec = on_spectrum(jnp.fft.rfft2(padded, axes=(-2, -1)))
    out = jnp.fft.irfft2(spec, s=(fft_h, fft_w), axes=(-2, -1))
    return out[..., bt : bt + h, bl : bl + w]


def blur_fft2(planar: jnp.ndarray, plan: BlurPlan) -> jnp.ndarray:
    """2-D FFT convolution of float32 planar channels ``(..., H, W)``."""
    fft_h = plan.fft_shape[0]
    ker_col = (
        _mirror_full(plan.col.spectrum, fft_h)
        if plan.col.symmetric
        else _mirror_full_c(plan.col.spectrum_c, fft_h)
    )
    # keep the two 1-D spectra as separate constants and let XLA fuse the
    # broadcast — materializing the outer product would bake an
    # O(fft_h * fft_w) constant into the program (~700 MB at 348 MP)
    def mult(spec):
        return (
            spec
            * jnp.asarray(ker_col)[:, None]
            * jnp.asarray(_axis_spectrum(plan.row))
        )

    return rfft2_pipeline(planar, plan, mult)


def _tile_pass(
    x: jnp.ndarray,
    axis_plan,
    axis: int,
    pffft_quirk: bool = False,
) -> jnp.ndarray:
    """One 1-D pass: reflect pad + trailing zeros, rFFT, xRe(ker), irFFT, crop.

    The whole image's rows (or columns) form the batch of a single rFFT —
    the data-parallel replacement for the reference's per-tile thread loop
    (``Source.cpp:353-366, 520-537``).
    """
    pad, n, flen = axis_plan.pad, axis_plan.dim, axis_plan.fft_len
    x = jnp.moveaxis(x, axis, -1)
    tile = reflect_101(x, [(pad, pad)])
    if flen > tile.shape[-1]:
        cfg = [(0, 0)] * (tile.ndim - 1) + [(0, flen - tile.shape[-1])]
        tile = jnp.pad(tile, cfg)

    spec = jnp.fft.rfft(tile, n=flen, axis=-1)
    if pffft_quirk:
        if not axis_plan.symmetric:
            raise ValueError(
                "pffft_quirk emulates the reference's real-spectrum multiply "
                "(symmetric taps only)"
            )
        spec = spec * jnp.asarray(_pffft_quirked(axis_plan.spectrum, flen))
    else:
        spec = spec * jnp.asarray(_axis_spectrum(axis_plan))
    out = jnp.fft.irfft(spec, n=flen, axis=-1)
    out = out[..., pad : pad + n]
    return jnp.moveaxis(out, -1, axis)


def blur_fft_tiles(
    planar: jnp.ndarray,
    plan: BlurPlan,
    pffft_quirk: bool = False,
) -> jnp.ndarray:
    """Separable 1-D tile path: rows pass then columns pass.

    ``pffft_quirk=True`` reproduces the reference pffft engine's
    ordered-layout Nyquist shortcut (``Source.cpp:414-427``) bit-for-bit in
    spectral math — exact flag-3 emulation when combined with
    ``size_mode="smooth235"`` (pffft's own transform-length rule).
    """
    out = _tile_pass(planar, plan.row, -1, pffft_quirk)
    out = _tile_pass(out, plan.col, -2, pffft_quirk)
    return out
