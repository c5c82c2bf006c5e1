"""Fast box blur — the FastBoxBlur capability as a parallel scan.

The reference delegates to the author's ``FastBoxBlur`` submodule
(``Source.cpp:587``): a sliding-accumulator horizontal box blur
(``out[i+1] = out[i] + in[i+r+1] - in[i-r]``), reflect borders, a cache
-blocked transpose between passes, run twice (``passes=2``) to approximate a
Gaussian with a tent. The sliding accumulator is an inherently *sequential*
recurrence — the CPU-optimal form. The data-parallel equivalent of the
same O(N) math is the **cumulative-sum difference**: with ``cs`` the
exclusive cumsum of the reflect-101-padded axis,
``box[i] = (cs[i + 2r + 1] - cs[i]) / (2r + 1)`` — a parallel scan,
replacing the data-dependent loop. ``box_blur_scan`` is the ``box_scan``
engine: all passes of one axis over one wider reflect pad, matching the
folded-taps plan (``ops/kernels.box_passes_kernel``) at every radius.

Accumulation is float32 across passes with a single final rounding
(the submodule is vendored empty in the reference snapshot; semantics
reconstructed from its call site and README — SURVEY.md §2 #21).

Call-site parity: the reference passes ``radius = nsmooth^2`` and
``passes = 2`` (``Source.cpp:587``).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from blur_algorithms.ops.layout import round_to_u8
from blur_algorithms.ops.pad import reflect_101

__all__ = [
    "box_blur_planar",
    "box_blur_axis",
    "box_blur_scan",
    "box_blur_scan_axis",
    "box_blur_scan_u8",
]


def box_blur_axis(x: jnp.ndarray, radius: int, axis: int) -> jnp.ndarray:
    """One box pass of width ``2*radius + 1`` along ``axis`` (reflect-101)."""
    if radius <= 0:
        return x
    n = x.shape[axis]
    r = min(radius, n - 1)  # clamp like Reflect_101 (Utils.hpp:217-220)
    width = 2 * r + 1
    x = jnp.moveaxis(x, axis, -1)
    padded = reflect_101(x, [(r, r)])
    cs = jnp.cumsum(padded, axis=-1, dtype=jnp.float32)
    zero = jnp.zeros(cs.shape[:-1] + (1,), cs.dtype)
    cs = jnp.concatenate([zero, cs], axis=-1)  # exclusive prefix sum
    out = (cs[..., width : width + n] - cs[..., 0:n]) * (1.0 / width)
    return jnp.moveaxis(out, -1, axis)


def box_blur_planar(planar: jnp.ndarray, radius: int, passes: int = 2) -> jnp.ndarray:
    """``passes`` x (rows box + cols box) on float32 planar ``(..., H, W)``."""
    out = planar
    for _ in range(max(1, int(passes))):
        out = box_blur_axis(out, radius, -1)
        out = box_blur_axis(out, radius, -2)
    return out


def box_blur_scan_axis(x: jnp.ndarray, radius: int, passes: int = 2) -> jnp.ndarray:
    """``passes`` box passes along the last axis of float ``(..., N)``.

    One reflect-101 pad of ``passes * r`` per side, clamped to ``N - 1``
    like the plan's folded taps (the effective per-pass radius is
    ``pad // passes``), then ``passes`` cumsum differences, each shrinking
    the span by ``2r``.
    """
    n = x.shape[-1]
    pad = min(passes * radius, n - 1) if n > 1 else 0
    r = pad // passes
    if radius <= 0 or r == 0:
        return x.astype(jnp.float32)
    x = reflect_101(x.astype(jnp.float32), [(passes * r, passes * r)])
    width = 2 * r + 1
    for _ in range(passes):
        m = x.shape[-1] - 2 * r
        cs = jnp.cumsum(x, axis=-1)
        lo = jnp.concatenate(
            [jnp.zeros(cs.shape[:-1] + (1,), cs.dtype), cs[..., : m - 1]],
            axis=-1,
        )
        x = (cs[..., width - 1 : width - 1 + m] - lo) * (1.0 / width)
    return x[..., :n]


@functools.partial(jax.jit, static_argnames=("radius", "passes"))
def box_blur_scan(planar: jnp.ndarray, radius: int, passes: int = 2) -> jnp.ndarray:
    """FastBoxBlur semantics on planar ``(..., H, W)`` -> float32: ``passes``
    box passes per axis (rows, then columns), reflect-101 borders.
    Differentiable through XLA."""
    out = box_blur_scan_axis(planar, radius, passes)
    return jnp.swapaxes(
        box_blur_scan_axis(jnp.swapaxes(out, -1, -2), radius, passes), -1, -2
    )


def box_blur_scan_u8(planar_u8: jnp.ndarray, radius: int, passes: int = 2) -> jnp.ndarray:
    """uint8 planar in, uint8 planar out (reference rounding)."""
    if radius <= 0:
        return planar_u8
    return round_to_u8(box_blur_scan(planar_u8, int(radius), int(passes)))
