"""Matmul FFT convolution: Bailey four-step DFTs as batched matmuls.

The reference's premise is FFT convolution ("Fast Fourier Convolution —
image processing", ``README.md:4``); its engines run scalar/SIMD FFTs on CPU
cores (pffft/pocketfft). This engine maps the transform itself onto matrix
units:
factor ``N = N1 * N2`` and express the length-N DFT as two batched complex
matmuls by ``(N1 x N1)`` / ``(N2 x N2)`` DFT matrices with a twiddle
multiply between them (Cooley-Tukey / Bailey's four-step; the same move
fbfft made on GPU tensor units) — ``O(N1 + N2) ~ O(sqrt N)`` MACs per
sample, independent of the kernel radius.

Two real rows ride one complex transform: a centered symmetric kernel has a
purely real spectrum ``H`` (``README.md:134``, ``Source.cpp:258``), so with
``z = a + i*b``, ``IFFT(H . FFT(z)) = (h*a) + i*(h*b)`` by linearity — no
CCS packing, no spectrum mirroring (the reference's ``Source.cpp:215-218``
unpack step), and the spectral multiply is a real elementwise scale in the
permuted ``(k1, k2)`` bin layout, which never needs reordering.

Border semantics match ``blur_fft_tiles`` (reflect-101 pad + trailing zeros
to the transform length, ``Source.cpp:297-306``), so outputs are
interchangeable with every other engine within float rounding. Complex
matmuls use the Gauss 3-multiplication trick; ``bf16x3`` splits each real
matmul into hi/lo bfloat16 passes (lo*lo dropped) like the fused engine.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from blur_algorithms.ops.kernels import wrap_centered
from blur_algorithms.ops.pad import reflect_101
from blur_algorithms.ops.plan import BlurPlan

__all__ = ["blur_fft_mxu"]


def _factor(n: int) -> tuple[int, int]:
    """Split ``n`` into DFT stage factors (n1, n2), n = n1 * n2.

    Unlike a real FFT library, the stages are dense matmuls against
    trace-time DFT matrices, so ANY factorization is legal. Composite
    lengths from ``transform_length`` are ``128 * m``: n1 = 128 keeps the
    stage-1 contraction on 128-wide tiles; small pow2 lengths (< 4096)
    split near sqrt(n) as before.
    """
    if n % 128 == 0 and n // 128 >= 32:
        return 128, n // 128
    lg = n.bit_length() - 1
    n1 = 1 << ((lg + 1) // 2)
    return n1, n // n1


@functools.lru_cache(maxsize=64)
def _stage_consts(n: int, factors: tuple[int, int] | None = None):
    """Trace-time DFT matrices and twiddles for length ``n``.

    ``factors`` overrides ``_factor(n)`` — the in-kernel-framing Pallas
    form uses ``(n // 128, 128)`` so its lane chunking is 128-aligned
    (any factorization is mathematically legal; the stages are dense
    matmuls).
    """
    n1, n2 = factors or _factor(n)

    def dft(m: int):
        k = np.arange(m)[:, None].astype(np.float64)
        t = np.arange(m)[None, :].astype(np.float64)
        ang = -2.0 * np.pi * k * t / m
        return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)

    f1 = dft(n1)
    f2 = dft(n2)
    k1 = np.arange(n1)[:, None].astype(np.float64)
    t2 = np.arange(n2)[None, :].astype(np.float64)
    ang = -2.0 * np.pi * k1 * t2 / n
    tw = (np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32))
    return n1, n2, f1, f2, tw


def _mm(mat, x, side: str, precision):
    """Real matmul of a (K, B) constant against x, contracting axis ``side``.

    ``sub``:  out[..., k, m] = sum_b mat[k, b] x[..., b, m]
    ``lane``: out[..., c, k] = sum_b mat[k, b] x[..., c, b]
    """
    eq = "kb,...bm->...km" if side == "sub" else "kb,...cb->...ck"
    if precision == "bf16x3":
        mh = mat.astype(jnp.bfloat16)
        ml = (mat - mh.astype(jnp.float32)).astype(jnp.bfloat16)
        xh = x.astype(jnp.bfloat16)
        xl = (x - xh.astype(jnp.float32)).astype(jnp.bfloat16)

        def e(a, b):
            return jnp.einsum(
                eq, a, b, precision=jax.lax.DotAlgorithmPreset.BF16_BF16_F32,
                preferred_element_type=jnp.float32,
            )

        return e(mh, xh) + e(mh, xl) + e(ml, xh)
    return jnp.einsum(eq, mat, x, precision=precision,
                      preferred_element_type=jnp.float32)


def _cmm(mat_re, mat_im, xre, xim, side: str, precision):
    """Complex matmul via Gauss's 3-multiplication identity."""
    p1 = _mm(mat_re, xre, side, precision)
    p2 = _mm(mat_im, xim, side, precision)
    p3 = _mm(mat_re + mat_im, xre + xim, side, precision)
    return p1 - p2, p3 - p1 - p2


def _fft4step(xre, xim, consts, precision, inverse: bool):
    """Length-N DFT of (..., n1, n2) complex data (row-major n = n1*n2 + n2).

    Forward output bin (k1, k2) holds natural frequency k1 + n1*k2; the
    inverse consumes that same layout. No reordering ever happens.
    """
    n1, n2, (f1re, f1im), (f2re, f2im), (twre, twim) = consts
    f1re, f1im = jnp.asarray(f1re), jnp.asarray(f1im)
    f2re, f2im = jnp.asarray(f2re), jnp.asarray(f2im)
    twre, twim = jnp.asarray(twre), jnp.asarray(twim)
    if inverse:
        f1im, f2im, twim = -f1im, -f2im, -twim

    if not inverse:
        # stage 1 over n1 (sublane), twiddle, stage 2 over n2 (lane)
        are, aim = _cmm(f1re, f1im, xre, xim, "sub", precision)
        are, aim = are * twre - aim * twim, are * twim + aim * twre
        return _cmm(f2re, f2im, are, aim, "lane", precision)
    # inverse: undo stage 2, conjugate twiddle, undo stage 1, scale 1/N
    are, aim = _cmm(f2re, f2im, xre, xim, "lane", precision)
    are, aim = are * twre - aim * twim, are * twim + aim * twre
    yre, yim = _cmm(f1re, f1im, are, aim, "sub", precision)
    s = 1.0 / (n1 * n2)
    return yre * s, yim * s


@functools.lru_cache(maxsize=256)
def _perm_spectrum_c(plan_axis, n: int, factors: tuple[int, int] | None = None):
    """(hre, him) correlation spectrum in (k1, k2) layout; him None when
    the taps are symmetric (purely real spectrum — the fast path)."""
    n1, n2 = factors or _factor(n)
    # conj: engines implement circular convolution; plan semantics are
    # correlation (see kernels.complex_spectrum). Re is conj-invariant, so
    # the symmetric path is unchanged.
    full = np.conj(np.fft.fft(wrap_centered(plan_axis.taps, n)))
    hre = np.ascontiguousarray(full.real.astype(np.float32).reshape(n2, n1).T)
    if plan_axis.symmetric:
        return hre, None
    him = np.ascontiguousarray(full.imag.astype(np.float32).reshape(n2, n1).T)
    return hre, him


def transform_length(axis_plan) -> int:
    """Planned transform length for one axis (shared by both forms).

    Short axes round up to the next pow2 (balanced near-sqrt factors);
    in 4096..16384 the length is the next ``128 * (multiple of 8)`` — the
    DFT stages are dense matmuls, so unlike a pow2-only FFT the zero-pad
    waste is bounded at ~3% instead of up to ~2x (e.g. a needed 4902 plans
    5120, not 8192). Past 16384 lengths snap to pow2, which usually
    unifies both axes to one N and so one set of DFT matrices.
    """
    need = axis_plan.dim + 2 * axis_plan.pad
    if need <= 4096 or need > 16384:
        return max(256, 1 << (need - 1).bit_length())
    m = -(-need // 128)  # lanes-of-128 chunks
    return 128 * (-(-m // 8) * 8)  # n2 a multiple of 8 (sublane granularity)


def conv_axis(x: jnp.ndarray, axis_plan, axis: int, conv_rows) -> jnp.ndarray:
    """Shared per-axis framing: reflect pad + trailing zeros to the pow2
    transform length, convolve every row via ``conv_rows(rows, n,
    axis_plan)``, crop the interior. Used by both the einsum form here and
    the fused Pallas kernel (``pallas_kernels/fft4step.py``) so their
    border/length semantics can never drift apart.
    """
    pad, dim = axis_plan.pad, axis_plan.dim
    if axis_plan.support_radius == 0:
        return x
    x = jnp.moveaxis(x, axis, -1)
    lead = x.shape[:-1]
    n = transform_length(axis_plan)
    tile = reflect_101(x, [(pad, pad)])
    tile = jnp.pad(
        tile, [(0, 0)] * (tile.ndim - 1) + [(0, n - tile.shape[-1])]
    )
    out = conv_rows(tile.reshape(-1, n), n, axis_plan)
    out = out[:, pad : pad + dim].reshape(lead + (dim,))
    return jnp.moveaxis(out, -1, axis)


def _conv_rows_einsum(rows: jnp.ndarray, n: int, axis_plan, precision):
    """(R, n) real rows -> circularly convolved rows, via XLA einsums."""
    n1, n2 = _factor(n)
    consts = _stage_consts(n)
    r = rows.shape[0]
    r2 = (r + 1) // 2
    if r % 2:
        rows = jnp.pad(rows, [(0, 1), (0, 0)])
    # two real rows per complex transform (kernel spectrum is purely real)
    zre = rows[:r2].reshape(r2, n1, n2)
    zim = rows[r2:].reshape(r2, n1, n2)

    sre, sim = _fft4step(zre, zim, consts, precision, inverse=False)
    hre, him = _perm_spectrum_c(axis_plan, n)
    hre = jnp.asarray(hre)
    if him is None:
        # symmetric taps: purely real spectrum (reference Source.cpp:258)
        sre, sim = sre * hre, sim * hre
    else:
        # asymmetric custom taps: full complex multiply — the packed
        # two-real-rows trick still holds because the KERNEL is real in
        # space, so conv(row) stays real and IFFT linearity separates them
        him = jnp.asarray(him)
        sre, sim = sre * hre - sim * him, sre * him + sim * hre
    yre, yim = _fft4step(sre, sim, consts, precision, inverse=True)

    return jnp.concatenate(
        [yre.reshape(r2, n), yim.reshape(r2, n)], axis=0
    )[:r]


def estimate_bytes(plan: BlurPlan, lead_elems: int = 3) -> int:
    """Rough peak HBM for the whole-frame padded f32 row intermediates.

    ``lead_elems`` is the product of every leading (batch x channel)
    dimension — the per-(H, W)-frame estimate times the batch factor.
    """
    h, w = plan.shape
    total = 0
    for axis_plan, rows in ((plan.row, lead_elems * h), (plan.col, lead_elems * w)):
        n = transform_length(axis_plan)
        total = max(total, 3 * rows * n * 4)  # in + complex out pair
    return total


def blur_fft_mxu(
    planar: jnp.ndarray, plan: BlurPlan, precision: str | object = "bf16x3"
) -> jnp.ndarray:
    """Separable FFT-convolution of float32 planar ``(..., H, W)`` as matmuls.

    Radius-independent cost (~O(sqrt N) MACs/px per axis); the engine for
    kernel radii beyond the banded-matmul paths' reach. ``precision``:
    ``"bf16x3"`` (default) or a ``jax.lax.Precision`` for full-f32 stages.
    """
    conv = functools.partial(_conv_rows_einsum, precision=precision)
    fn = lambda rows, n, ap: conv(rows, n, ap)
    out = conv_axis(planar.astype(jnp.float32), plan.row, -1, fn)
    return conv_axis(out, plan.col, -2, fn)
