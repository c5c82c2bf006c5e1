"""DFT_image debug mode: log-magnitude spectrum export.

Reference ``#define DFT_image`` (``Source.cpp:13, 240-252``): instead of
blurring, export ``20*log10(|Re(spectrum)| + 1e-5)`` of the padded image,
fftshifted with MATLAB's odd/even convention (``:244-247``) and the CCS
half-spectrum mirror-read of ``:247``. The gather indices are precomputed at
trace time with NumPy so the device program is a single rFFT + gather + log.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from blur_algorithms.ops.pad import reflect_101
from blur_algorithms.ops.plan import BlurPlan

__all__ = ["dft_spectrum_planar"]


def dft_spectrum_planar(planar: jnp.ndarray, plan: BlurPlan) -> jnp.ndarray:
    """Log-magnitude spectrum of float32 planar ``(..., H, W)``.

    Output shape ``(..., fft_h, fft_w)`` (the padded/FFT-sized grid, as the
    reference writes the spectrum into the padded buffer).
    """
    (bt, bb), (bl, br) = plan.col.border, plan.row.border
    padded = reflect_101(planar, [(bt, bb), (bl, br)])
    s0, s1 = plan.fft_shape
    spec = jnp.fft.rfft2(padded, axes=(-2, -1))

    rows = np.arange(s0)
    cols = np.arange(s1)
    row_ = (rows + (s0 if s0 % 2 == 0 else s0 + 1) // 2) % s0
    col_ = (cols + (s1 if s1 % 2 == 0 else s1 + 1) // 2) % s1
    half = s1 // 2 + 1
    # replicates the reference's index math exactly; note its formula equals
    # the true mirror (s1 - col_) only for even s1 — odd lengths would read
    # one bin off, but the size planners (here and in the reference) only
    # ever produce even transform lengths
    cval = np.where(col_ < half, col_, (s1 // 2) - col_ % (s1 // 2))

    re = jnp.real(spec)[..., row_[:, None], cval[None, :]]
    return 20.0 * jnp.log10(jnp.abs(re) + np.float32(1e-5))
