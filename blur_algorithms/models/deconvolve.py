"""Closed-form Wiener deconvolution through the blur's own spectra.

The framework's blurs are circular convolutions by a separable kernel with
a purely real spectrum (``ops/kernels.real_spectrum``, the reference's
centering trick ``Source.cpp:96-100``). That makes the inverse problem a
single fused dispatch: one 2-D rFFT, a per-bin Wiener gain

    W(k) = H(k) / (H(k)^2 + balance)

built on the fly from the two 1-D kernel spectra (never materialized as a
2-D constant), and one inverse transform. The gradient-descent counterpart
lives in ``examples/deblur.py`` (explicit-adjoint autodiff); this is the
direct solve. Borders use the same reflect-101 geometry as the forward
blur, so border bins are approximate in the usual Wiener sense — interior
recovery is tested in ``tests/test_deconvolve.py``.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from blur_algorithms.ops.fft_conv import _mirror_full, rfft2_pipeline
from blur_algorithms.ops.plan import make_plan

__all__ = ["wiener_deconvolve"]


@functools.lru_cache(maxsize=64)
def _compiled_wiener(
    shape: tuple[int, ...],
    nsmooth: float,
    balance: float,
    kernel: str,
    size_mode: str,
    out_u8: bool,
):
    h, w = shape[-2], shape[-1]
    plan = make_plan((h, w), nsmooth, kernel=kernel, size_mode=size_mode)
    if not (plan.col.symmetric and plan.row.symmetric):
        raise ValueError("wiener_deconvolve expects a symmetric blur kernel")
    hc = _mirror_full(plan.col.spectrum, plan.fft_shape[0])  # real, full

    def gain(spec):
        # per-bin gain H/(H^2 + balance), fused from the 1-D spectra
        h2d = jnp.asarray(hc)[:, None] * jnp.asarray(plan.row.spectrum)
        return spec * (h2d / (h2d * h2d + balance))

    def fn(planar):
        out = rfft2_pipeline(planar.astype(jnp.float32), plan, gain)
        if out_u8:
            from blur_algorithms.ops.layout import round_to_u8

            return round_to_u8(out)
        return out

    return jax.jit(fn)


def wiener_deconvolve(
    img: jnp.ndarray,
    nsmooth: float,
    balance: float = 1e-3,
    kernel: str = "gaussian",
    size_mode: str = "auto",
) -> jnp.ndarray:
    """Invert a framework blur: uint8 interleaved or float planar input.

    ``nsmooth``/``kernel`` name the forward blur exactly as :func:`blur`
    does; ``balance`` is the Wiener regularizer (noise-to-signal ratio) —
    smaller recovers more detail but amplifies noise at bins the blur
    crushed. One compiled program per (shape, blur, balance).
    """
    img = jnp.asarray(img)
    if img.dtype == jnp.uint8:
        from blur_algorithms.ops import layout

        planar = layout.to_planar(img)
        fn = _compiled_wiener(
            tuple(planar.shape), float(nsmooth), float(balance), kernel,
            size_mode, True,
        )
        return jnp.moveaxis(fn(planar), -3, -1)
    fn = _compiled_wiener(
        tuple(img.shape), float(nsmooth), float(balance), kernel,
        size_mode, False,
    )
    return fn(img)
