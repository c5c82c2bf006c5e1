"""The fused band engine: one route decision for the platform it runs on.

On a GPU the fused band kernel (``pallas_kernels/fused_band.py``) serves
every plan within its measured reach (``fused_band.MAX_RADIUS``); anywhere
else, and past that radius, the XLA band route (``ops/band_matmul`` at
full float32 precision) computes the same blur. AUTO hands radii past the
kernel's reach to the FFT on a GPU, so there the XLA route serves only
explicit ``fused`` requests. A GPU never runs the kernel in interpret
mode; only tests ask for that.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from blur_algorithms.ops.band_matmul import band_conv_valid, blur_band_matmul
from blur_algorithms.ops.layout import round_to_u8
from blur_algorithms.ops.pad import reflect_101
from blur_algorithms.ops.plan import BlurPlan
from blur_algorithms.pallas_kernels import fused_band

__all__ = ["blur_fused", "blur_fused_u8", "blur_fused_haloed", "kernel_tiling"]

_HIGHEST = jax.lax.Precision.HIGHEST


def kernel_tiling(plan: BlurPlan, in_bytes: int) -> fused_band.Tiling | None:
    """The kernel's tiling when it serves ``plan`` on this platform, else
    None (the XLA band route serves)."""
    if jax.default_backend() != "gpu":
        return None
    h, w = plan.shape
    return fused_band.pick_tiling(
        plan.col.support_radius, plan.row.support_radius, h, w, in_bytes
    )


def blur_fused(planar: jnp.ndarray, plan: BlurPlan) -> jnp.ndarray:
    """Separable blur of planar ``(..., H, W)`` (float or uint8) -> float32.

    Differentiable for float input on both routes.
    """
    x = jnp.asarray(planar)
    t = kernel_tiling(plan, 1 if x.dtype == jnp.uint8 else 4)
    if t is None:
        return blur_band_matmul(x.astype(jnp.float32), plan, _HIGHEST)
    if x.dtype == jnp.uint8:
        return fused_band.fused_band_call(x, plan, t, out_u8=False)
    return fused_band.blur_fused_band(x.astype(jnp.float32), plan, t)


def blur_fused_u8(planar_u8: jnp.ndarray, plan: BlurPlan) -> jnp.ndarray:
    """uint8 planar ``(..., H, W)`` in, uint8 out (reference rounding)."""
    t = kernel_tiling(plan, 1)
    if t is None:
        return round_to_u8(
            blur_band_matmul(planar_u8.astype(jnp.float32), plan, _HIGHEST)
        )
    return fused_band.blur_fused_band_u8(planar_u8, plan, t)


def blur_fused_haloed(
    planar: jnp.ndarray, plan: BlurPlan, out_u8: bool = False
) -> jnp.ndarray:
    """Blur of ``(..., H + 2*rh, W)`` whose ``rh`` extra rows on each side
    are halo context supplied by the caller (a neighbouring shard); returns
    ``(..., H, W)``. Columns still reflect locally.
    """
    x = jnp.asarray(planar)
    t = kernel_tiling(plan, 1 if x.dtype == jnp.uint8 else 4)
    if t is not None:
        return fused_band.fused_band_call(
            x, plan, t, out_u8=out_u8, pre_padded_col=True
        )
    h, w = plan.shape
    rw = plan.row.support_radius
    y = jnp.moveaxis(x.astype(jnp.float32), -2, -1)
    y = jnp.moveaxis(band_conv_valid(y, plan.col.taps, h, _HIGHEST), -1, -2)
    y = band_conv_valid(
        reflect_101(y, [(rw, rw)], axes=[-1]), plan.row.taps, w, _HIGHEST
    )
    return round_to_u8(y) if out_u8 else y
