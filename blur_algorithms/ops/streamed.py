"""Strip-streamed blur for images too large to transform whole.

The reference's answer to memory pressure was its 1-D tile engines: one row
at a time, plans reused (``README.md:69-71``). The device-sized equivalent
processes *strips* per dispatch step so peak device memory stays
O(image) + O(strip) instead of several full-size float copies (one f32
intermediate + strips; the last strip CLAMPS instead of padding the frame
to whole strips, which would materialize a full f32 temp copy).

Layout strategy: the rows pass slices strips of rows and transforms axis -1;
the columns pass slices strips of *columns* and transforms axis -2 directly
— no full-image transpose copy ever exists (the reference needed
``flip_block`` here; XLA transposes only the small strip internally).
uint8 pipelines convert per strip on the way in and round per strip on the
way out, so only one full-size float32 intermediate is ever alive.

Numerically identical to ``blur_fft_tiles`` (same pads, spectra, crops).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from blur_algorithms.ops.layout import round_to_u8
from blur_algorithms.ops.pad import reflect_101
from blur_algorithms.ops.plan import BlurPlan

__all__ = [
    "blur_fft_tiles_streamed",
    "blur_fft_tiles_streamed_u8",
    "estimate_fft_tiles_bytes",
]


def estimate_fft_tiles_bytes(plan: BlurPlan, channels: int = 3) -> int:
    """Rough peak-HBM estimate of the whole-image tile path (f32 + c64)."""
    h, w = plan.shape
    per_px = 4 + 8  # padded f32 + half-spectrum complex64, worst axis
    return channels * max(h * plan.row.fft_len, w * plan.col.fft_len) * per_px


def _fft_blur_chunk(chunk: jnp.ndarray, axis_plan, axis: int) -> jnp.ndarray:
    """Reflect-pad + rFFT + x ker-spectrum + irFFT + crop along ``axis``.

    Real spectrum for symmetric taps (the reference trick), full complex
    half-spectrum for asymmetric custom taps (``kernels.complex_spectrum``).
    """
    from blur_algorithms.ops.fft_conv import _axis_spectrum

    pad, n, flen = axis_plan.pad, axis_plan.dim, axis_plan.fft_len
    spectrum = jnp.asarray(_axis_spectrum(axis_plan))
    chunk = jnp.moveaxis(chunk, axis, -1)
    tile = reflect_101(chunk, [(pad, pad)])
    spec = jnp.fft.rfft(tile, n=flen, axis=-1)
    out = jnp.fft.irfft(spec * spectrum, n=flen, axis=-1)[..., pad : pad + n]
    return jnp.moveaxis(out, -1, axis)


def _pass_over_strips(
    x: jnp.ndarray,
    axis_plan,
    fft_axis: int,
    strip_axis: int,
    strip: int,
    out_dtype,
) -> jnp.ndarray:
    """Blur along ``fft_axis``, streaming strips sliced along ``strip_axis``."""
    fft_axis %= x.ndim
    strip_axis %= x.ndim
    n_strip = x.shape[strip_axis]
    strip = min(strip, n_strip)
    nstrips = -(-n_strip // strip)

    # No whole-frame pad-to-strips: that would materialize a full f32
    # copy of the frame as XLA temp next to the output carry. Instead the
    # LAST strip's start clamps to n - strip: its overlap rows recompute values
    # byte-identical to the previous strip's (each output row depends only
    # on its own input row along the conv axis), so the double write is
    # harmless and peak memory stays O(frame) + O(strip).
    out0 = jnp.zeros(x.shape, out_dtype)
    sizes = list(x.shape)
    sizes[strip_axis] = strip

    def body(i, out):
        starts = [0] * x.ndim
        starts[strip_axis] = jnp.minimum(i * strip, n_strip - strip)
        chunk = jax.lax.dynamic_slice(x, starts, sizes)
        blurred = _fft_blur_chunk(chunk.astype(jnp.float32), axis_plan, fft_axis)
        if out_dtype == jnp.uint8:
            blurred = round_to_u8(blurred)
        else:
            blurred = blurred.astype(out_dtype)
        return jax.lax.dynamic_update_slice(out, blurred, starts)

    return jax.lax.fori_loop(0, nstrips, body, out0)


@functools.partial(jax.jit, static_argnames=("plan", "strip"))
def _blur_fft_tiles_streamed_impl(
    planar: jnp.ndarray, plan: BlurPlan, strip: int = 1024
) -> jnp.ndarray:
    x = _pass_over_strips(planar, plan.row, -1, -2, strip, jnp.float32)
    return _pass_over_strips(x, plan.col, -2, -1, strip, jnp.float32)


@functools.partial(jax.custom_vjp, nondiff_argnums=(1, 2))
def blur_fft_tiles_streamed(
    planar: jnp.ndarray, plan: BlurPlan, strip: int = 1024
) -> jnp.ndarray:
    """Float32 planar ``(..., H, W)`` in/out, strip-streamed FFT blur.

    Differentiable via the explicit blur adjoint (the strip loop's
    ``fori_loop``/``dynamic_update_slice`` has no efficient transpose);
    the backward pass runs the whole-frame adjoint, so gradients of frames
    near the HBM limit may exceed it — stream the cotangent in that regime.
    """
    return _blur_fft_tiles_streamed_impl(planar, plan, strip)


def _tiles_streamed_fwd(planar, plan, strip):
    return blur_fft_tiles_streamed(planar, plan, strip), None


def _streamed_bwd(plan, _strip, _res, ct):
    from blur_algorithms.ops.adjoint import blur_adjoint

    return (blur_adjoint(ct, plan),)


blur_fft_tiles_streamed.defvjp(_tiles_streamed_fwd, _streamed_bwd)


@functools.partial(jax.jit, static_argnames=("plan", "strip"))
def blur_fft_tiles_streamed_u8(
    planar_u8: jnp.ndarray, plan: BlurPlan, strip: int = 1024
) -> jnp.ndarray:
    """uint8 planar in -> uint8 planar out with one f32 intermediate.

    Rows pass converts u8 strips to float on the fly; columns pass rounds
    strips back to u8 on the way out.
    """
    x = _pass_over_strips(planar_u8, plan.row, -1, -2, strip, jnp.float32)
    return _pass_over_strips(x, plan.col, -2, -1, strip, jnp.uint8)
