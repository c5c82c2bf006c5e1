"""Direct separable convolution engine (``lax.conv``).

The reference's FFT engines compute, exactly, a linear convolution of the
reflect-101-padded image with the truncated normalized kernel taps (the
zero-pad to FFT length makes circular == linear convolution; SURVEY.md §7).
This engine does that convolution *directly* — O(N·width) fused
multiply-adds — instead of round-tripping through two rFFTs, and is
therefore numerically interchangeable with ``blur_fft2``/``blur_fft_tiles``
(same taps, same borders, float rounding differences only).

Implementation: reflect pad per axis, then ``lax.conv_general_dilated`` with
the 1-D taps as a ``1x1xK`` filter, rows pass then columns pass, channels and
frames batched into a single dispatch.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from blur_algorithms.ops.pad import reflect_101
from blur_algorithms.ops.plan import BlurPlan

__all__ = ["blur_conv"]


def _conv_pass(
    x: jnp.ndarray, axis_plan, axis: int, precision: jax.lax.Precision
) -> jnp.ndarray:
    """1-D valid convolution along ``axis`` of reflect-padded data."""
    radius = axis_plan.support_radius
    taps = np.asarray(axis_plan.taps, dtype=np.float32)

    x = jnp.moveaxis(x, axis, -1)
    padded = reflect_101(x, [(radius, radius)])

    lead = padded.shape[:-1]
    n_pad = padded.shape[-1]
    # (batch, feature=1, spatial): all rows/channels/frames are one conv batch.
    inp = padded.reshape((-1, 1, n_pad))
    # XLA conv is cross-correlation (no kernel flip), which is exactly this
    # framework's convention (band/fused/oracle all correlate) — taps as-is
    ker = jnp.asarray(taps).reshape((1, 1, -1))
    out = jax.lax.conv_general_dilated(
        inp,
        ker,
        window_strides=(1,),
        padding="VALID",
        dimension_numbers=("NCH", "OIH", "NCH"),
        precision=precision,
    )
    out = out.reshape(lead + (axis_plan.dim,))
    return jnp.moveaxis(out, -1, axis)


def blur_conv(
    planar: jnp.ndarray,
    plan: BlurPlan,
    precision: jax.lax.Precision = jax.lax.Precision.HIGHEST,
) -> jnp.ndarray:
    """Separable direct-convolution blur of float32 planar ``(..., H, W)``."""
    out = _conv_pass(planar, plan.row, -1, precision)
    out = _conv_pass(out, plan.col, -2, precision)
    return out
