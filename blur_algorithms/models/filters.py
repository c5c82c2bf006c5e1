"""Composite filters built on the blur engines (unsharp masking et al.).

The reference's comparison corpora (``test_images/Clean Up Comparisons``,
SURVEY.md §4) exist because blurs are building blocks of photographic
clean-up pipelines. This module provides the classic composites as single
compiled programs: the blur runs on the fused band engine with a
float result, the pointwise combine fuses into the same dispatch, and uint8
rounds once at the end (no double rounding through an intermediate u8).
"""

from __future__ import annotations

import functools
from typing import Any

import jax
import jax.numpy as jnp

from blur_algorithms.ops.layout import round_to_u8
from blur_algorithms.ops.plan import make_plan
from blur_algorithms.ops import fused

__all__ = ["unsharp_mask", "high_pass"]


@functools.lru_cache(maxsize=128)
def _compiled_unsharp(
    shape: tuple[int, ...],
    is_u8: bool,
    sigma: float,
    amount: float,
    threshold: int,
    size_mode: str,
) -> Any:
    h, w = (shape[-3], shape[-2]) if is_u8 else (shape[-2], shape[-1])
    plan = make_plan((h, w), sigma, size_mode=size_mode)

    def sharpen_planar(x):
        xf = x.astype(jnp.float32)
        low = fused.blur_fused(x, plan)
        detail = xf - low
        if threshold:
            # classic threshold: only boost detail above the cutoff
            detail = jnp.where(jnp.abs(detail) >= threshold, detail, 0.0)
        return xf + amount * detail

    if is_u8:

        def fn(img):
            planar = jnp.moveaxis(img, -1, -3)
            out = round_to_u8(sharpen_planar(planar))
            return jnp.moveaxis(out, -3, -1)

    else:
        fn = sharpen_planar
    return jax.jit(fn)


def unsharp_mask(
    img: jnp.ndarray,
    sigma: float,
    amount: float = 1.0,
    threshold: int = 0,
    size_mode: str = "auto",
) -> jnp.ndarray:
    """Unsharp masking: ``out = x + amount * (x - gaussian_blur(x))``.

    uint8 interleaved ``(..., H, W, C)`` in -> uint8 out (one rounding at
    the end); float planar ``(..., H, W)`` in -> float32 out. ``threshold``
    (uint8 counts) suppresses detail below the cutoff — the classic
    noise-safe variant. The blur and the combine compile into one program.
    """
    is_u8 = img.dtype == jnp.uint8
    if is_u8 and img.ndim < 3:
        raise ValueError(
            f"uint8 input must be interleaved (..., H, W, C), got {img.shape}"
        )
    fn = _compiled_unsharp(
        tuple(img.shape), is_u8, float(sigma), float(amount),
        int(threshold), size_mode,
    )
    return fn(img)


def high_pass(
    img: jnp.ndarray, sigma: float, size_mode: str = "auto"
) -> jnp.ndarray:
    """High-pass residual ``x - gaussian_blur(x)`` as float32 planar.

    Accepts uint8 interleaved or float planar; always returns float planar
    (the residual is signed). The frequency-domain complement of the blur —
    the spatial twin of the reference's ``DFT_image`` spectrum study.
    """
    if img.dtype == jnp.uint8:
        if img.ndim < 3:
            raise ValueError(
                f"uint8 input must be interleaved (..., H, W, C), "
                f"got {img.shape}"
            )
        x = jnp.moveaxis(img, -1, -3)
        h, w = img.shape[-3], img.shape[-2]
    else:
        x = img
        h, w = img.shape[-2], img.shape[-1]
    return _compiled_high_pass((h, w), float(sigma), size_mode)(x)


@functools.lru_cache(maxsize=128)
def _compiled_high_pass(
    shape: tuple[int, int], sigma: float, size_mode: str
) -> Any:
    plan = make_plan(shape, sigma, size_mode=size_mode)

    def fn(x):
        return x.astype(jnp.float32) - fused.blur_fused(x, plan)

    return jax.jit(fn)
