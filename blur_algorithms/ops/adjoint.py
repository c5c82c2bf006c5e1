"""Adjoint of the blur operator — gradients for the Pallas kernel.

The blur is linear: ``y = Crop . ValidConv(taps) . ReflectPad101``. Its
adjoint per axis is ``ReflectPad101^T . ValidConv(taps)^T``:

* ``ValidConv^T`` = zero-pad the cotangent by ``2r`` per side and run the
  valid conv with FLIPPED taps (identical for the blur kernels, which are
  symmetric; required for asymmetric custom taps);
* ``ReflectPad101^T`` = fold: each reflected pad sample scatters its
  cotangent back onto the interior pixel it mirrored (positions ``1..r``
  from the left pad, ``n-2..n-r-1`` from the right pad). Pad excess beyond
  the ``dim-1`` clamp was zero-filled in the forward pass and contributes
  nothing.

The jnp engines (fft/band/conv) are differentiable through XLA already;
this explicit adjoint exists so the fused band kernel and the strip loop of
the streamed FFT get a ``custom_vjp`` (and it is also cheaper than autodiff
through an FFT pair).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from blur_algorithms.ops.band_matmul import band_conv_valid
from blur_algorithms.ops.plan import BlurPlan

__all__ = ["blur_adjoint"]


def _valid_conv_wide(padded: jnp.ndarray, axis_plan, n_out: int) -> jnp.ndarray:
    """Valid conv along the last axis via the circular matmul-DFT conv.

    For wide kernels the band path's materialized windows tensor outgrows
    HBM (mirrors the forward AUTO routing); with enough trailing zeros a
    circular conv with the centered taps equals the valid conv at offset r.
    """
    r = axis_plan.support_radius
    length = padded.shape[-1]
    n = max(256, 1 << (length - 1).bit_length())
    lead = padded.shape[:-1]
    rows = jnp.pad(
        padded, [(0, 0)] * (padded.ndim - 1) + [(0, n - length)]
    ).reshape(-1, n)
    from blur_algorithms.ops.fft_mxu import _conv_rows_einsum

    out = _conv_rows_einsum(
        rows, n, axis_plan, precision=jax.lax.Precision.HIGHEST
    )
    return out[:, r : r + n_out].reshape(lead + (n_out,))


# above this support radius the adjoint leaves the banded-windows path,
# whose materialized windows tensor grows with the radius
_ADJOINT_FFT_MIN_RADIUS = 1024


def _adjoint_axis(ct: jnp.ndarray, axis_plan, axis: int) -> jnp.ndarray:
    r = axis_plan.support_radius
    n = axis_plan.dim
    if r == 0:
        return ct
    ct = jnp.moveaxis(ct, axis, -1)

    # ValidConv^T: zero-pad by 2r, valid conv with FLIPPED taps; symmetry
    # comes from the plan (one definition — the same property the FFT
    # engines use to pick real vs complex spectra)
    taps = np.asarray(axis_plan.taps)
    flipped = np.ascontiguousarray(taps[::-1])
    symmetric = axis_plan.symmetric
    cfg = [(0, 0)] * (ct.ndim - 1) + [(2 * r, 2 * r)]
    if r > _ADJOINT_FFT_MIN_RADIUS and symmetric:
        # spectrum path: valid only for symmetric taps (real spectrum)
        z = _valid_conv_wide(jnp.pad(ct, cfg), axis_plan, n + 2 * r)
    else:
        z = band_conv_valid(
            jnp.pad(ct, cfg), flipped, n + 2 * r, jax.lax.Precision.HIGHEST
        )

    # ReflectPad^T: fold pad cotangents onto their mirror sources
    out = z[..., r : r + n]
    eff = min(r, n - 1)  # forward pad was clamped to dim - 1
    if eff > 0:
        left = z[..., r - eff : r][..., ::-1]  # pad pos r-1..r-eff -> src 1..eff
        out = out.at[..., 1 : eff + 1].add(left)
        right = z[..., r + n : r + n + eff][..., ::-1]  # -> src n-2..n-1-eff
        out = out.at[..., n - 1 - eff : n - 1].add(right)
    return jnp.moveaxis(out, -1, axis)


def blur_adjoint(ct: jnp.ndarray, plan: BlurPlan) -> jnp.ndarray:
    """Apply the adjoint of the planned blur to cotangent ``(..., H, W)``."""
    out = _adjoint_axis(ct.astype(jnp.float32), plan.row, -1)
    out = _adjoint_axis(out, plan.col, -2)
    return out
