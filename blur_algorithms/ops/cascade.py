"""Cascade engine: huge-sigma Gaussian as k composed narrower blurs.

Gaussian blurs form a semigroup: blurring with sigma_1 then sigma_2 equals
one blur with sqrt(sigma_1^2 + sigma_2^2). A sigma too wide for one band
pass decomposes into ``k`` identical steps of ``sigma / sqrt(k)``, each
running on the fused band engine. Steps are made as large as the step
radius cap allows: composing more, smaller steps compounds truncation
error, so the minimal ``k`` is taken.

This is an *approximation* relative to the reference's single truncated
kernel: truncated+renormalized Gaussians compose only approximately (each
step clips its tails at the reference's own 1/255 threshold). Measured
deviation stays within a few uint8 counts; the parity engines (fft*/band)
remain the bit-accurate paths, so ``auto`` never picks cascade — it is an
explicit opt-in for throughput at extreme sigma.
"""

from __future__ import annotations

import functools
import math

from blur_algorithms.ops import kernels
from blur_algorithms.ops.plan import make_plan

__all__ = ["cascade_sigmas", "blur_cascade"]

# each step's support radius stays under this cap
_STEP_MAX_RADIUS = 4000


def _radius_for(sigma: float) -> int:
    return (kernels.gaussian_window(sigma) - 1) // 2


def cascade_sigmas(sigma: float) -> list[float]:
    """Split ``sigma`` into the fewest equal steps the fused engine fits."""
    k = 1
    while _radius_for(sigma / math.sqrt(k)) > _STEP_MAX_RADIUS:
        k += 1
        if k > 64:
            raise ValueError(f"sigma {sigma} too large to cascade")
    return [sigma / math.sqrt(k)] * k


@functools.lru_cache(maxsize=64)
def _cascade_plans(shape: tuple[int, int], sigma: float, size_mode: str):
    return tuple(
        make_plan(shape, s, kernel="gaussian", size_mode=size_mode)
        for s in cascade_sigmas(sigma)
    )


def blur_cascade(planar, sigma: float, size_mode: str = "auto"):
    """Cascaded fused blur of float planar ``(..., H, W)`` (or uint8 in)."""
    from blur_algorithms.ops.fused import blur_fused

    h, w = planar.shape[-2], planar.shape[-1]
    out = planar
    for plan in _cascade_plans((h, w), float(sigma), size_mode):
        out = blur_fused(out, plan)
    return out


def blur_cascade_u8(planar_u8, sigma: float, size_mode: str = "auto"):
    """uint8 planar in/out: intermediate steps stay float32, one rounding."""
    from blur_algorithms.ops.layout import round_to_u8

    return round_to_u8(blur_cascade(planar_u8, sigma, size_mode))
