"""Fused separable band blur for NVIDIA Hopper (Pallas, Triton route).

One program per (plane, output tile) runs both separable passes without an
intermediate in device memory. The frame is reflect-101 padded once by the
kernel radius (and zero-filled so every window load is in bounds); each
program then walks its input window in row chunks of ``kc`` rows:

    u8 chunk (kc, ww) --bf16--> rows pass  X @ Bw        (2 dots: taps hi, lo)
                                cols pass  acc += BhT_k @ Y  (3 dots: split)

and ends with the reference's ``floor(x + 0.5)`` rounding, a clip and a u8
store (or an f32 store for float frames). ``Bw`` is the ``(ww, tw)`` banded
matrix of the row taps, ``BhT`` the transposed ``(th, nk*kc)`` banded matrix
of the column taps; both arrive as stacked bfloat16 hi/lo halves so every
dot is a bf16 tensor-core product with float32 accumulation. uint8 pixels
are exact in bfloat16, so the u8 rows pass needs only the two tap halves;
float frames also split the pixels (3 dots). The result is within float32
rounding of the XLA band route (``ops/band_matmul``), which serves radii
past the kernel's reach (``MAX_RADIUS``) and every non-GPU platform.

The kernel moves about ``(1 + 2r/t)^2`` bytes per pixel in (mostly L2 hits
on the overlapping windows) and one out, where the plain XLA route writes
and re-reads a float32 window tensor and intermediate on each pass.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from blur_algorithms.ops.band_matmul import band_block_matrix
from blur_algorithms.ops.pad import reflect_101
from blur_algorithms.ops.plan import BlurPlan

__all__ = [
    "Tiling",
    "blur_fused_band",
    "blur_fused_band_u8",
    "pick_tiling",
    "smem_bytes",
]

# every dot in the kernel multiplies bfloat16 halves into float32
_BF16_DOT = jax.lax.DotAlgorithmPreset.BF16_BF16_F32

# Tilings measured fastest on an H100 SXM (700 W) at 4K, uint8, radius
# 32..192 (PERF.md, "Tiling sweep"): (th, tw, kc) with 4 warps and 2
# pipeline stages, by the row radius they serve. Windows 512 columns wide
# (radius >= 128) ran 2-3x slower than the XLA band route, so the kernel
# serves radii up to MAX_RADIUS on both axes and no further.
_TILINGS = ((48, (128, 32, 64)), (96, (64, 64, 64)), (112, (128, 32, 64)))
MAX_RADIUS = 112


@dataclasses.dataclass(frozen=True)
class Tiling:
    """Static geometry of one kernel launch.

    ``th x tw`` output tile; the input window is ``nk`` chunks of ``kc``
    rows (``nk * kc >= th + 2*rh``) by ``ww`` columns (power of two
    ``>= tw + 2*rw``). ``warps`` and ``stages`` are Triton's launch
    parameters.
    """

    th: int
    tw: int
    kc: int
    nk: int
    ww: int
    warps: int = 4
    stages: int = 2


def _next_pow2(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length()


def smem_bytes(t: Tiling, in_bytes: int) -> int:
    """Upper estimate of the shared memory one program holds.

    The dot operands of one chunk step, as bfloat16: the window chunk (hi
    and, for float frames, lo), both halves of ``Bw``, the chunk's columns
    of ``BhT`` and the split rows-pass result; the pipelined loads (window
    chunk and ``BhT`` chunk) are counted once per pipeline stage.
    """
    x_planes = 1 if in_bytes == 1 else 2
    window = t.kc * t.ww * (in_bytes + 2 * x_planes)
    bht = 2 * t.th * t.kc * 2
    pipelined = t.stages * (window + bht)
    bw = 2 * t.ww * t.tw * 2
    y = 2 * t.kc * t.tw * 2
    return pipelined + bw + y


def _smem_limit() -> int:
    from blur_algorithms.utils.hw import H100

    return H100.smem_block_bytes


@functools.lru_cache(maxsize=512)
def pick_tiling(rh: int, rw: int, h: int, w: int, in_bytes: int) -> Tiling | None:
    """The measured tiling for these radii, or None past the kernel's reach.

    Tiles shrink (to powers of two, at least 16) for frames smaller than
    them; the window stays a power of two at least ``tw + 2*rw`` wide. The
    row chunk halves until the program fits a block's shared memory
    (float frames carry 8 bytes per window pixel, uint8 ones 3).
    """
    if max(rh, rw) > MAX_RADIUS:
        return None
    th, tw, kc = next(t for r, t in _TILINGS if rw <= r)
    th = min(th, max(16, _next_pow2(h)))
    tw = min(tw, max(16, _next_pow2(w)))
    kc = min(kc, max(16, _next_pow2(th + 2 * rh)))
    ww = _next_pow2(tw + 2 * rw)
    while True:
        t = Tiling(th, tw, kc, -(-(th + 2 * rh) // kc), ww)
        if smem_bytes(t, in_bytes) <= _smem_limit():
            return t
        if kc == 16:
            return None
        kc //= 2


def _split_bf16(v):
    hi = v.astype(jnp.bfloat16)
    lo = (v - hi.astype(jnp.float32)).astype(jnp.bfloat16)
    return hi, lo


def _dot(a, b):
    return jax.lax.dot_general(
        a, b, (((1,), (0,)), ((), ())),
        precision=_BF16_DOT, preferred_element_type=jnp.float32,
    )


def _kernel(x_ref, bw_ref, bht_ref, o_ref, *, t: Tiling, h: int, w: int,
            out_u8: bool):
    n, i, j = pl.program_id(0), pl.program_id(1), pl.program_id(2)
    row0, col0 = i * t.th, j * t.tw
    u8_in = x_ref.dtype == jnp.uint8

    def chunk(k, acc):
        x = plgpu.load(
            x_ref.at[n, pl.ds(row0 + k * t.kc, t.kc), pl.ds(col0, t.ww)]
        ).astype(jnp.float32)
        bw_hi = plgpu.load(bw_ref.at[0])
        bw_lo = plgpu.load(bw_ref.at[1])
        if u8_in:
            xb = x.astype(jnp.bfloat16)  # exact: integers <= 255
            y = _dot(xb, bw_hi) + _dot(xb, bw_lo)
        else:
            x_hi, x_lo = _split_bf16(x)
            y = _dot(x_hi, bw_hi) + _dot(x_hi, bw_lo) + _dot(x_lo, bw_hi)
        y_hi, y_lo = _split_bf16(y)
        cols = pl.ds(k * t.kc, t.kc)
        b_hi = plgpu.load(bht_ref.at[0, :, cols])
        b_lo = plgpu.load(bht_ref.at[1, :, cols])
        return acc + _dot(b_hi, y_hi) + _dot(b_hi, y_lo) + _dot(b_lo, y_hi)

    acc = jax.lax.fori_loop(
        0, t.nk, chunk, jnp.zeros((t.th, t.tw), jnp.float32)
    )
    if out_u8:
        acc = jnp.clip(jnp.floor(acc + 0.5), 0.0, 255.0)
        acc = acc.astype(jnp.int32).astype(jnp.uint8)
    rows = row0 + jnp.arange(t.th)
    cols = col0 + jnp.arange(t.tw)
    mask = (rows < h)[:, None] & (cols < w)[None, :]
    plgpu.store(
        o_ref.at[n, pl.ds(row0, t.th), pl.ds(col0, t.tw)], acc, mask=mask
    )


def _split_matrix(m: np.ndarray) -> jnp.ndarray:
    hi = m.astype(jnp.bfloat16)
    lo = (m - hi.astype(np.float32)).astype(jnp.bfloat16)
    return jnp.asarray(np.stack([hi, lo]))


def _band_operands(plan: BlurPlan, t: Tiling):
    """Stacked bf16 hi/lo ``Bw (2, ww, tw)`` and ``BhT (2, th, nk*kc)``."""
    bw = band_block_matrix(plan.row.taps, t.tw)
    bw = np.pad(bw, [(0, t.ww - bw.shape[0]), (0, 0)])
    bht = band_block_matrix(plan.col.taps, t.th).T
    bht = np.pad(bht, [(0, 0), (0, t.nk * t.kc - bht.shape[1])])
    return _split_matrix(bw), _split_matrix(bht)


@functools.partial(
    jax.jit,
    static_argnames=("plan", "t", "out_u8", "pre_padded_col", "interpret"),
)
def fused_band_call(
    planar: jnp.ndarray,
    plan: BlurPlan,
    t: Tiling,
    out_u8: bool,
    pre_padded_col: bool = False,
    interpret: bool = False,
) -> jnp.ndarray:
    """Run the kernel on planar ``(..., H, W)`` (u8 or float) frames.

    ``pre_padded_col``: the input already carries ``rh`` halo rows above
    and below (the sharded path's exchange); only the columns reflect here.
    """
    h, w = plan.shape
    rh, rw = plan.col.support_radius, plan.row.support_radius
    lead = planar.shape[:-2]
    x = planar.reshape((-1,) + planar.shape[-2:])
    if x.dtype != jnp.uint8:
        x = x.astype(jnp.float32)
    row_pads = (0, 0) if pre_padded_col else (rh, rh)
    x = reflect_101(x, [row_pads, (rw, rw)], axes=[-2, -1])
    nbh, nbw = -(-h // t.th), -(-w // t.tw)
    hp = (nbh - 1) * t.th + t.nk * t.kc
    wp = (nbw - 1) * t.tw + t.ww
    x = jnp.pad(x, [(0, 0), (0, hp - x.shape[-2]), (0, wp - x.shape[-1])])
    bw, bht = _band_operands(plan, t)
    out = pl.pallas_call(
        functools.partial(_kernel, t=t, h=h, w=w, out_u8=out_u8),
        grid=(x.shape[0], nbh, nbw),
        # inside shard_map the output varies over the same mesh axes as
        # the frame (the band operands are constants)
        out_shape=jax.ShapeDtypeStruct(
            (x.shape[0], h, w), jnp.uint8 if out_u8 else jnp.float32,
            vma=jax.typeof(x).vma,
        ),
        backend="triton",
        compiler_params=plgpu.CompilerParams(
            num_warps=t.warps, num_stages=t.stages
        ),
        interpret=interpret,
        name="fused_band_blur",
    )(x, bw, bht)
    return out.reshape(lead + (h, w))


def blur_fused_band_u8(
    planar_u8: jnp.ndarray, plan: BlurPlan, t: Tiling, interpret: bool = False
) -> jnp.ndarray:
    """uint8 planar ``(..., H, W)`` in, uint8 out."""
    return fused_band_call(planar_u8, plan, t, True, interpret=interpret)


@functools.partial(jax.custom_vjp, nondiff_argnums=(1, 2, 3))
def blur_fused_band(
    planar: jnp.ndarray, plan: BlurPlan, t: Tiling, interpret: bool = False
) -> jnp.ndarray:
    """Float planar ``(..., H, W)`` in, float32 out; differentiable.

    The blur is linear, so its VJP is the adjoint operator
    (``ops/adjoint.py``); a Pallas call has no automatic transpose.
    """
    return fused_band_call(planar, plan, t, False, interpret=interpret)


def _fwd(planar, plan, t, interpret):
    return blur_fused_band(planar, plan, t, interpret), None


def _bwd(plan, t, interpret, _res, ct):
    from blur_algorithms.ops.adjoint import blur_adjoint

    return (blur_adjoint(ct, plan),)


blur_fused_band.defvjp(_fwd, _bwd)
