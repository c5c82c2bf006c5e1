"""Banded-block matmul blur engine — the XLA band route.

A 1-D convolution with taps of support ``2r + 1`` is a multiplication by a
banded Toeplitz matrix. Dense Toeplitz matmul wastes O(N/r) of the work;
instead the axis is cut into blocks of ``T`` outputs, and each block is an
``(T + 2r) x T`` small dense matmul of an overlapping input window with a
banded block matrix — O((T + 2r)/(2r + 1)) waste, tunable via ``T``.

This engine computes the *same* truncated-kernel reflect-101 convolution as
the FFT engines (SURVEY.md §7: circular convolution with trailing zeros ==
linear convolution with the taps), so it is interchangeable with the
reference paths. It is the portable twin of the fused band kernel
(``pallas_kernels/fused_band.py``): the route wherever that kernel does
not run.

Precision: ``HIGHEST`` is full float32; ``"bf16x3"`` splits both operands
into bfloat16 hi/lo halves and sums three bf16 products with float32
accumulation (the lo*lo term dropped) — within one uint8 rounding count of
the oracle, on the tensor cores. uint8-valued inputs are exact in bfloat16.
Every product names its precision: the backend default may be TF32.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from blur_algorithms.ops.pad import reflect_101
from blur_algorithms.ops.plan import BlurPlan

__all__ = ["blur_band_matmul", "band_block_matrix", "band_conv_valid", "pick_block"]


def band_block_matrix(taps: np.ndarray, block: int) -> np.ndarray:
    """Banded block matrix ``B[(block + 2r) x block]``: ``B[k, j] = taps[k - j]``.

    ``window @ B`` convolves every length-``block + 2r`` input window down to
    ``block`` outputs ("valid" convolution with correlation orientation —
    symmetric taps make conv == corr; taps from the kernel factory are
    symmetric by construction).
    """
    width = int(taps.shape[0])
    r = (width - 1) // 2
    rows = block + 2 * r
    mat = np.zeros((rows, block), dtype=np.float32)
    for j in range(block):
        mat[j : j + width, j] = taps
    return mat


def pick_block(n: int, radius: int) -> int:
    """Output-block size: >= ~4r to bound band waste, 128-aligned, <= n."""
    t = max(128, 128 * ((4 * radius + 127) // 128))
    # don't exceed the axis (rounded up to a lane multiple)
    n_aligned = 128 * ((n + 127) // 128)
    return min(t, max(n_aligned, 128))


def band_conv_valid(
    padded: jnp.ndarray,
    taps: np.ndarray,
    n_out: int,
    precision=jax.lax.Precision.HIGHEST,
    block: int | None = None,
) -> jnp.ndarray:
    """Valid banded convolution along the last axis via blocked matmuls.

    ``padded`` must already carry ``r = (len(taps)-1)//2`` extra samples on
    each side of the ``n_out`` interior (any border policy: reflect, halo
    rows from a neighbor device, zeros). Shared by the single-chip engine
    and the sharded spatial path (which supplies halos via ``ppermute``).
    """
    taps = np.asarray(taps, dtype=np.float32)
    r = (int(taps.shape[0]) - 1) // 2
    if r == 0:
        return padded[..., :n_out]
    t = block or pick_block(n_out, r)

    nblocks = -(-n_out // t)
    total = nblocks * t
    if total + 2 * r > padded.shape[-1]:
        cfg = [(0, 0)] * (padded.ndim - 1) + [(0, total + 2 * r - padded.shape[-1])]
        padded = jnp.pad(padded, cfg)

    if nblocks == 1:
        windows = padded[None, ..., : t + 2 * r]  # (1, ..., t + 2r)
    else:
        windows = jnp.stack(
            [padded[..., i * t : i * t + t + 2 * r] for i in range(nblocks)], axis=0
        )  # (nb, ..., t + 2r)

    mat = jnp.asarray(band_block_matrix(taps, t))  # (t + 2r, t)
    dims = (((windows.ndim - 1,), (0,)), ((), ()))
    if precision == "bf16x3":
        # hi/lo bfloat16 splits, lo*lo dropped — the fused kernel's accuracy
        # class (~1 uint8 count)
        m_hi = mat.astype(jnp.bfloat16)
        m_lo = (mat - m_hi.astype(jnp.float32)).astype(jnp.bfloat16)
        x_hi = windows.astype(jnp.bfloat16)
        x_lo = (windows - x_hi.astype(jnp.float32)).astype(jnp.bfloat16)

        def dot(a, b):
            return jax.lax.dot_general(
                a, b, dims, precision=jax.lax.DotAlgorithmPreset.BF16_BF16_F32,
                preferred_element_type=jnp.float32,
            )

        # both tap halves in one product: XLA may fold a sum of two
        # products of one operand into a product of the summed (and
        # bf16-rounded) halves, which would drop the lo half
        both = dot(x_hi, jnp.concatenate([m_hi, m_lo], axis=1))
        out = both[..., :t] + both[..., t:] + dot(x_lo, m_hi)
    else:
        out = jax.lax.dot_general(
            windows,
            mat,
            dimension_numbers=dims,
            precision=precision,
            preferred_element_type=jnp.float32,
        )  # (nb, ..., t)
    out = jnp.moveaxis(out, 0, -2)  # (..., nb, t)
    return out.reshape(out.shape[:-2] + (total,))[..., :n_out]


def _band_pass(
    x: jnp.ndarray,
    axis_plan,
    axis: int,
    precision,
    block: int | None,
) -> jnp.ndarray:
    r = axis_plan.support_radius
    if r == 0:
        return x
    x = jnp.moveaxis(x, axis, -1)
    padded = reflect_101(x, [(r, r)])  # (..., n + 2r)
    out = band_conv_valid(padded, axis_plan.taps, axis_plan.dim, precision, block)
    return jnp.moveaxis(out, -1, axis)


def blur_band_matmul(
    planar: jnp.ndarray,
    plan: BlurPlan,
    precision=jax.lax.Precision.HIGHEST,
    block: int | None = None,
) -> jnp.ndarray:
    """Separable banded-matmul blur of float32 planar ``(..., H, W)``."""
    out = _band_pass(planar, plan.row, -1, precision, block)
    out = _band_pass(out, plan.col, -2, precision, block)
    return out
