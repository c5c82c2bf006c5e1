"""Public API: one-call blurs with jit caching per static configuration.

The reference's engine dispatcher ``Test`` (``Source.cpp:574-608``) maps CLI
flags to engines; that enum survives here as :class:`Engine` plus
``FLAG_TO_ENGINE`` for CLI parity:

==== ======================== ==========================================
flag reference engine          engine here
==== ======================== ==========================================
5    pocketfft_1D tiles        ``fft_tiles``
4    FastBoxBlur               ``box`` (effective taps, fused or scan)
3    pffft 1-D tiles           ``fft_tiles`` (``pffft`` for exact emulation
                               incl. the Nyquist shortcut, Source.cpp:414-427)
2    pocketfft_2D              ``fft2``
1    cv::GaussianBlur baseline ``conv`` (lax.conv direct path)
==== ======================== ==========================================

Engines beyond the parity set:

* ``fused``   — the fused band engine (``ops/fused.py``): the Hopper band
  kernel on a GPU, the XLA band route elsewhere and past the kernel's
  shared-memory reach;
* ``band``    — the XLA band route (blocked banded matmuls) explicitly;
* ``fft_mxu`` — the DFT written as matmuls (Bailey four-step, XLA einsums);
* ``auto``    — ``fused`` up to the device's measured crossover radius,
  past it ``fft_tiles`` (``jnp.fft``), strip-streamed when the frame's
  transform intermediates outgrow the device budget; multi-device sharding
  engages when more than one device is visible (``_auto_sharded_fn``).

Every (shape, nsmooth, engine, options) tuple is a distinct jit
specialization, cached process-wide; compiled programs fuse
deinterleave -> blur -> interleave into one dispatch.
"""

from __future__ import annotations

import enum
import functools
import math
from typing import Any

import jax
import jax.numpy as jnp

from blur_algorithms.ops import box_blur as box_ops
from blur_algorithms.ops import (
    band_matmul,
    direct_conv,
    fft_conv,
    fused,
    layout,
    spectrum,
)
from blur_algorithms.ops.plan import BlurPlan, make_custom_plan, make_plan

__all__ = [
    "Engine",
    "FLAG_TO_ENGINE",
    "blur",
    "blur_u8",
    "gaussian_blur",
    "box_blur",
    "convolve_separable",
    "dft_spectrum",
]


class Engine(str, enum.Enum):
    FFT2 = "fft2"
    FFT_TILES = "fft_tiles"
    # the reference flag-3 engine's exact spectral math, incl. its
    # ordered-layout Nyquist shortcut (Source.cpp:414-427); pair with
    # size_mode="smooth235" for bit-level flag-3 emulation
    PFFFT = "pffft"
    CONV = "conv"
    BAND = "band"
    FUSED = "fused"
    BOX = "box"
    BOX_SCAN = "box_scan"  # cumsum-difference scan: O(1)/px in radius
    FFT_MXU = "fft_mxu"  # Bailey 4-step DFT as matmuls (radius-free)
    FFT_STREAM = "fft_stream"  # strip-streamed tiles for giant images
    CASCADE = "cascade"  # huge sigma as k composed blurs (approximation)
    DERICHE = "deriche"  # recursive Gaussian: O(1)/px in sigma (<=1 count)
    AUTO = "auto"


FLAG_TO_ENGINE = {
    5: Engine.FFT_TILES,
    4: Engine.BOX,
    3: Engine.FFT_TILES,
    2: Engine.FFT2,
    1: Engine.CONV,
}

# AUTO: the band engines' O(radius) work against the radius-independent
# FFT. The crossovers are device-keyed in utils/hw.DeviceSpec, measured on
# the card (PERF.md "Crossover probe"). The Deriche recursive engine
# (sigma-independent cost) stays an explicit engine: see ops/deriche.py.


def _budgets():
    from blur_algorithms.utils.hw import budgets

    return budgets()


def _resolve_engine(
    engine: Engine | str, plan: BlurPlan, in_bytes: int = 1, lead: int = 3
) -> Engine:
    """The engine AUTO runs for ``plan`` on ``lead`` planes of its frame."""
    engine = Engine(engine)
    if engine is not Engine.AUTO:
        return engine
    b = _budgets()
    r = max(plan.col.support_radius, plan.row.support_radius)
    crossover = (
        b.auto_fused_max_radius_u8 if in_bytes == 1
        else b.auto_fused_max_radius_f32
    )
    if r <= crossover:
        return Engine.FUSED
    from blur_algorithms.ops.streamed import estimate_fft_tiles_bytes

    if estimate_fft_tiles_bytes(plan, lead) > b.fft_mxu_byte_budget:
        return Engine.FFT_STREAM
    return Engine.FFT_TILES


def _blur_planar(x: jnp.ndarray, plan: BlurPlan, engine: Engine) -> jnp.ndarray:
    if engine is Engine.FFT2:
        return fft_conv.blur_fft2(x, plan)
    if engine is Engine.FFT_TILES:
        return fft_conv.blur_fft_tiles(x, plan)
    if engine is Engine.PFFFT:
        return fft_conv.blur_fft_tiles(x, plan, pffft_quirk=True)
    if engine is Engine.CONV:
        return direct_conv.blur_conv(x, plan)
    if engine is Engine.BAND:
        return band_matmul.blur_band_matmul(x, plan, precision="bf16x3")
    if engine is Engine.FUSED:
        return fused.blur_fused(x, plan)
    if engine is Engine.FFT_MXU:
        from blur_algorithms.ops.fft_mxu import blur_fft_mxu, estimate_bytes
        from blur_algorithms.ops.streamed import blur_fft_tiles_streamed

        lead = max(1, math.prod(x.shape[:-2]))
        if estimate_bytes(plan, lead) > _budgets().fft_mxu_byte_budget:
            # frames too big to transform whole stream strips
            return blur_fft_tiles_streamed(x, plan)
        return blur_fft_mxu(x, plan, precision=jax.lax.Precision.HIGHEST)
    if engine is Engine.BOX_SCAN:
        if plan.kernel != "box_fast":
            raise ValueError("box_scan engine requires a box_fast plan")
        return box_ops.box_blur_scan(x, int(plan.sigma), plan.box_passes)
    if engine is Engine.FFT_STREAM:
        from blur_algorithms.ops.streamed import blur_fft_tiles_streamed

        return blur_fft_tiles_streamed(x, plan)
    if engine is Engine.DERICHE:
        if plan.kernel != "gaussian" or plan.sigma_x is not None:
            raise ValueError(
                "deriche engine approximates isotropic gaussian kernels only"
            )
        from blur_algorithms.ops.deriche import blur_deriche

        return blur_deriche(x, plan.sigma)
    raise ValueError(f"engine {engine} is not a planar blur engine")


def _fused_u8_interleaved(plan: BlurPlan):
    """uint8 (..., H, W, C) -> uint8 via the fused engine, u8 end to end."""

    def fn(img):
        planar = jnp.moveaxis(img, -1, -3)
        return jnp.moveaxis(fused.blur_fused_u8(planar, plan), -3, -1)

    return fn


def _auto_sp_min_px() -> int:
    """AUTO row-shards a single frame over the devices only from this pixel
    count on (device-keyed, ``DeviceSpec.auto_sp_min_px``): below it one
    device finishes so fast that the halo exchange and dispatch of a
    row-sharded step do not pay."""
    return _budgets().auto_sp_min_px


def _auto_sharded_fn(shape: tuple[int, ...], plan: BlurPlan, is_u8: bool):
    """Multi-device AUTO routing.

    Returns a sharded callable, or None to stay single-device. Batches
    (4-D) shard dp over frames — indivisible batch/height pad-and-crop
    inside :func:`parallel.blur_sharded`, so divisibility is NOT required
    — with leftover devices sharding rows (sp) when the batch is smaller
    than the device count. A single frame (3-D) above
    ``DeviceSpec.auto_sp_min_px`` shards its rows over all devices. Float
    and uint8 inputs both route; per-shard compute is the same fused band
    engine as on one device, so results stay in the same <=1-count
    accuracy class. Multi-host stays single-device: batches are host-local
    and sharding them over the global mesh would need a distributed array
    the caller didn't build.
    """
    if jax.process_count() != 1 or len(jax.devices()) <= 1:
        return None
    ndev = len(jax.devices())
    from blur_algorithms.parallel import (
        blur_sharded,
        blur_sharded_u8,
        make_mesh,
    )

    if len(shape) == 4 and shape[0] >= 2:
        # dp over frames; if B < ndev, spare devices shard rows — but
        # only when the per-frame pixel count clears the same floor as
        # single-frame sp-sharding (sub-floor frames don't amortize the
        # halo exchange). Below the floor the batch stays dp-only on a
        # device subset.
        dp = max(
            d for d in range(1, ndev + 1) if ndev % d == 0 and d <= shape[0]
        )
        sp = ndev // dp
        if sp > 1 and plan.shape[0] * plan.shape[1] < _auto_sp_min_px():
            mesh = make_mesh(dp=dp, sp=1, devices=jax.devices()[:dp])
        else:
            mesh = make_mesh(dp=dp, sp=sp)
    elif len(shape) == 3 and plan.shape[0] * plan.shape[1] >= _auto_sp_min_px():
        mesh = make_mesh(dp=1, sp=ndev)
    else:
        return None

    if is_u8:
        if len(shape) == 3:

            def fn_sharded(img):
                return blur_sharded_u8(img[None], plan, mesh)[0]

        else:

            def fn_sharded(img):
                return blur_sharded_u8(img, plan, mesh)

    else:
        if len(shape) == 3:

            def fn_sharded(x):
                return blur_sharded(
                    x.astype(jnp.float32)[None], plan, mesh
                )[0]

        else:

            def fn_sharded(x):
                return blur_sharded(x.astype(jnp.float32), plan, mesh)

    fn_sharded._sharded = True  # observable routing marker for tests
    return fn_sharded


def _norm_nsmooth(nsmooth) -> float | tuple[float, float]:
    """Hashable nsmooth: float, or (sigma_y, sigma_x) for anisotropic
    gaussian requests (collapsed to a float when the two agree)."""
    if isinstance(nsmooth, (tuple, list)):
        if len(nsmooth) != 2:
            raise ValueError(
                f"anisotropic sigma needs (sigma_y, sigma_x), got {nsmooth}"
            )
        sy, sx = float(nsmooth[0]), float(nsmooth[1])
        return sy if sy == sx else (sy, sx)
    return float(nsmooth)


def _make_box_plan(h: int, w: int, nsmooth: float, size_mode: str) -> BlurPlan:
    # FastBoxBlur call-site semantics: radius = nsmooth^2, 2 passes
    # (Source.cpp:587), folded into effective taps (see box_passes_kernel).
    if isinstance(nsmooth, tuple):
        raise ValueError("box engines take a single scalar nsmooth")
    radius = int(float(nsmooth) * float(nsmooth))
    return make_plan((h, w), radius, kernel="box_fast", size_mode=size_mode)


def _box_engine(plan: BlurPlan, in_bytes: int, lead: int) -> Engine:
    """AUTO for a box plan: the folded taps through the fused engine while
    they are narrow, the O(1)/px cumsum scan past the device's crossover
    (and wherever AUTO would take the FFT)."""
    eng = _resolve_engine(Engine.AUTO, plan, in_bytes, lead)
    r = max(plan.col.support_radius, plan.row.support_radius)
    if eng is not Engine.FUSED or r > _budgets().box_scan_crossover_radius:
        return Engine.BOX_SCAN
    return eng


@functools.lru_cache(maxsize=256)
def _plan_for(
    h: int,
    w: int,
    nsmooth: float,
    engine: Engine,
    kernel: str,
    size_mode: str,
    in_bytes: int = 1,
    lead: int = 3,
) -> tuple[BlurPlan, Engine]:
    if engine in (Engine.BOX, Engine.BOX_SCAN):
        plan = _make_box_plan(h, w, nsmooth, size_mode)
        if engine is Engine.BOX_SCAN:
            return plan, Engine.BOX_SCAN
        return plan, _box_engine(plan, in_bytes, lead)
    plan = make_plan((h, w), nsmooth, kernel=kernel, size_mode=size_mode)
    return plan, _resolve_engine(engine, plan, in_bytes, lead)


def _planar_u8_fn(planar_fn):
    """Interleaved uint8 -> planar uint8 ``planar_fn`` -> interleaved."""

    def fn(img):
        return jnp.moveaxis(planar_fn(jnp.moveaxis(img, -1, -3)), -3, -1)

    return fn


@functools.lru_cache(maxsize=256)
def _compiled_planar(
    shape: tuple[int, ...],
    dtype: Any,
    nsmooth: float,
    engine: Engine,
    kernel: str,
    size_mode: str,
) -> Any:
    if Engine(engine) is Engine.CASCADE:
        if isinstance(nsmooth, tuple):
            raise ValueError("cascade engine takes a single scalar sigma")
        from blur_algorithms.ops.cascade import blur_cascade

        return jax.jit(
            lambda x: blur_cascade(x.astype(jnp.float32), nsmooth, size_mode)
        )
    plan, eng = _plan_for(
        shape[-2], shape[-1], nsmooth, engine, kernel, size_mode, in_bytes=4,
        lead=max(1, math.prod(shape[:-2])),
    )

    if Engine(engine) is Engine.AUTO and eng in (
        Engine.FUSED, Engine.FFT_TILES, Engine.FFT_STREAM
    ):
        fn_sharded = _auto_sharded_fn(shape, plan, is_u8=False)
        if fn_sharded is not None:
            return fn_sharded

    def fn(x):
        return _blur_planar(x.astype(jnp.float32), plan, eng)

    return jax.jit(fn)


@functools.lru_cache(maxsize=256)
def _compiled_u8(
    shape: tuple[int, ...],
    nsmooth: float,
    engine: Engine,
    kernel: str,
    size_mode: str,
) -> Any:
    if Engine(engine) is Engine.CASCADE:
        if isinstance(nsmooth, tuple):
            raise ValueError("cascade engine takes a single scalar sigma")
        from blur_algorithms.ops.cascade import blur_cascade_u8

        return jax.jit(_planar_u8_fn(
            lambda planar: blur_cascade_u8(planar, nsmooth, size_mode)
        ))

    plan, eng = _plan_for(
        shape[-3], shape[-2], nsmooth, engine, kernel, size_mode,
        lead=max(1, math.prod(shape[:-3]) * shape[-1]),
    )

    # multi-device AUTO: blur_sharded's own router runs the fused engine
    # per shard where it serves and the distributed FFT past the
    # crossover, so every AUTO resolution shards safely
    if Engine(engine) is Engine.AUTO and eng in (
        Engine.FUSED, Engine.FFT_TILES, Engine.FFT_STREAM
    ):
        fn_sharded = _auto_sharded_fn(shape, plan, is_u8=True)
        if fn_sharded is not None:
            return fn_sharded

    if eng is Engine.FUSED:
        return jax.jit(_fused_u8_interleaved(plan))

    if eng is Engine.FFT_STREAM:
        # uint8 strips in/out: only one full-size f32 intermediate exists
        from blur_algorithms.ops.streamed import blur_fft_tiles_streamed_u8

        return jax.jit(_planar_u8_fn(
            lambda planar: blur_fft_tiles_streamed_u8(planar, plan)
        ))

    if eng is Engine.DERICHE:
        if plan.kernel != "gaussian" or plan.sigma_x is not None:
            raise ValueError(
                "deriche engine approximates isotropic gaussian kernels only"
            )
        from blur_algorithms.ops.deriche import blur_deriche_u8

        return jax.jit(_planar_u8_fn(
            lambda planar: blur_deriche_u8(planar, plan.sigma)
        ))

    if eng is Engine.BOX_SCAN:
        return jax.jit(_planar_u8_fn(
            lambda planar: box_ops.box_blur_scan_u8(
                planar, int(plan.sigma), plan.box_passes
            )
        ))

    def fn(img):
        planar = layout.to_planar(img)
        return layout.from_planar(_blur_planar(planar, plan, eng))

    return jax.jit(fn)


def blur(
    planar: jnp.ndarray,
    nsmooth: float,
    engine: Engine | str = Engine.AUTO,
    kernel: str = "gaussian",
    size_mode: str = "auto",
) -> jnp.ndarray:
    """Blur float planar data ``(..., H, W)``; returns float32.

    ``nsmooth`` is sigma for ``kernel="gaussian"`` — a float, or a
    ``(sigma_y, sigma_x)`` pair for an anisotropic Gaussian; for
    ``engine="box"`` it follows the reference call site (radius =
    nsmooth^2, 2 passes, ``Source.cpp:587``).
    """
    fn = _compiled_planar(
        tuple(planar.shape),
        jnp.asarray(planar).dtype,
        _norm_nsmooth(nsmooth),
        Engine(engine),
        kernel,
        size_mode,
    )
    return fn(planar)


def blur_u8(
    img: jnp.ndarray,
    nsmooth: float,
    engine: Engine | str = Engine.AUTO,
    kernel: str = "gaussian",
    size_mode: str = "auto",
) -> jnp.ndarray:
    """Blur interleaved uint8 ``(..., H, W, C)``; returns uint8.

    The full reference pipeline (deinterleave -> blur -> +0.5 interleave,
    ``Source.cpp:459-567``) as one fused jit program.
    """
    img = jnp.asarray(img)
    if img.dtype != jnp.uint8:
        raise TypeError(f"blur_u8 expects uint8, got {img.dtype}")
    if img.ndim < 3:
        raise ValueError("blur_u8 expects (..., H, W, C)")
    fn = _compiled_u8(
        tuple(img.shape), _norm_nsmooth(nsmooth), Engine(engine), kernel,
        size_mode,
    )
    return fn(img)


def gaussian_blur(img: jnp.ndarray, sigma: float, **kwargs) -> jnp.ndarray:
    """True Gaussian blur; uint8 interleaved or float planar, auto-detected."""
    img = jnp.asarray(img)
    if img.dtype == jnp.uint8:
        return blur_u8(img, sigma, **kwargs)
    return blur(img, sigma, **kwargs)


@functools.lru_cache(maxsize=256)
def _compiled_box(
    shape: tuple[int, ...], is_u8: bool, radius: int, passes: int,
    size_mode: str,
) -> Any:
    h, w = (shape[-3], shape[-2]) if is_u8 else (shape[-2], shape[-1])
    plan = make_plan((h, w), radius, kernel="box_fast", size_mode=size_mode,
                     box_passes=passes)
    lead = math.prod(shape[:-3]) * shape[-1] if is_u8 else math.prod(shape[:-2])
    eng = _box_engine(plan, 1 if is_u8 else 4, max(1, lead))
    if not is_u8:
        return jax.jit(lambda x: _blur_planar(x.astype(jnp.float32), plan, eng))
    if eng is Engine.FUSED:
        return jax.jit(_fused_u8_interleaved(plan))
    return jax.jit(_planar_u8_fn(
        lambda planar: box_ops.box_blur_scan_u8(planar, radius, plan.box_passes)
    ))


def box_blur(
    img: jnp.ndarray,
    nsmooth: float,
    passes: int = 2,
    size_mode: str = "auto",
) -> jnp.ndarray:
    """FastBoxBlur-parity box blur: radius = nsmooth^2, default 2 passes.

    ``passes`` sequential reflect-101 box passes are folded into one
    effective-taps pass (mathematically identical; ``ops/kernels.py``).
    """
    img = jnp.asarray(img)
    radius = int(float(nsmooth) * float(nsmooth))
    is_u8 = img.dtype == jnp.uint8
    fn = _compiled_box(tuple(img.shape), is_u8, radius, int(passes), size_mode)
    return fn(img)


@functools.lru_cache(maxsize=128)
def _compiled_spectrum(h: int, w: int, nsmooth: float, size_mode: str) -> Any:
    plan = make_plan((h, w), nsmooth, size_mode=size_mode)
    return jax.jit(lambda x: spectrum.dft_spectrum_planar(x, plan))


def dft_spectrum(
    img: jnp.ndarray, nsmooth: float = 1.0, size_mode: str = "auto"
) -> jnp.ndarray:
    """``DFT_image`` mode: log-magnitude spectrum of each channel.

    Accepts uint8 ``(..., H, W, C)`` or float planar ``(..., H, W)``; pads
    exactly like the fft2 blur at the same ``nsmooth`` (the reference reuses
    the blur geometry, ``Source.cpp:240-252``).
    """
    img = jnp.asarray(img)
    if img.dtype == jnp.uint8:
        planar = layout.to_planar(img)
    else:
        planar = img.astype(jnp.float32)
    fn = _compiled_spectrum(
        planar.shape[-2], planar.shape[-1], float(nsmooth), size_mode
    )
    return fn(planar)


# ---------------------------------------------------------------------------
# Arbitrary separable filters (beyond the reference's blur kernels)

@functools.lru_cache(maxsize=128)
def _custom_setup(
    h: int,
    w: int,
    tr_bytes: bytes,
    tc_bytes: bytes,
    engine: Engine,
    size_mode: str,
    in_bytes: int,
) -> tuple[BlurPlan, Engine]:
    import numpy as np

    tr = np.frombuffer(tr_bytes, dtype=np.float32)
    tc = np.frombuffer(tc_bytes, dtype=np.float32)
    plan = make_custom_plan((h, w), tr, tc, size_mode)
    eng = Engine(engine)
    if eng is Engine.AUTO:
        # asymmetric taps run through every FFT engine too: the spectrum
        # pipeline carries the full complex correlation spectrum
        # (kernels.complex_spectrum) when Im != 0, so AUTO's routing needs
        # no symmetric special-casing
        eng = _resolve_engine(Engine.AUTO, plan, in_bytes)
    elif eng in (Engine.BOX, Engine.BOX_SCAN, Engine.CASCADE):
        raise ValueError(f"engine {eng.value} does not take custom taps")
    return plan, eng


@functools.lru_cache(maxsize=128)
def _compiled_custom(
    shape: tuple[int, ...],
    is_u8: bool,
    tr_bytes: bytes,
    tc_bytes: bytes,
    engine: Engine,
    size_mode: str,
) -> Any:
    h, w = (shape[-3], shape[-2]) if is_u8 else (shape[-2], shape[-1])
    plan, eng = _custom_setup(
        h, w, tr_bytes, tc_bytes, engine, size_mode, 1 if is_u8 else 4
    )
    if is_u8:
        if eng is Engine.FUSED:
            fn = _fused_u8_interleaved(plan)

        else:

            def fn(img):
                planar = layout.to_planar(img)
                return layout.from_planar(_blur_planar(planar, plan, eng))

        return jax.jit(fn)
    return jax.jit(lambda x: _blur_planar(x.astype(jnp.float32), plan, eng))


def convolve_separable(
    img: jnp.ndarray,
    taps_row,
    taps_col=None,
    engine: Engine | str = Engine.AUTO,
    size_mode: str = "auto",
) -> jnp.ndarray:
    """Arbitrary separable correlation filter with reflect-101 borders.

    Beyond the reference (blur-only): any odd-length 1-D taps per axis —
    sharpen, difference-of-Gaussians, derivative/edge filters — through the
    same engine lattice and border semantics as the blurs (see
    ``ops.plan.make_custom_plan`` for the exact semantics). uint8
    interleaved ``(..., H, W, C)`` rounds/clips back to uint8; float
    planar ``(..., H, W)`` returns float32. Every
    engine takes asymmetric taps — FFT engines carry the full complex
    correlation spectrum (``kernels.complex_spectrum``) when Im != 0.
    """
    import numpy as np

    taps_col = taps_row if taps_col is None else taps_col
    tr = np.ascontiguousarray(np.asarray(taps_row, np.float32).reshape(-1))
    tc = np.ascontiguousarray(np.asarray(taps_col, np.float32).reshape(-1))
    is_u8 = img.dtype == jnp.uint8
    if is_u8 and img.ndim < 3:
        raise ValueError(
            f"uint8 input must be interleaved (..., H, W, C), got {img.shape}"
        )
    fn = _compiled_custom(
        tuple(img.shape), is_u8, tr.tobytes(), tc.tobytes(),
        Engine(engine), size_mode,
    )
    return fn(img)
