"""Sharded blur: dp over frames, sp over image rows with halo exchange.

Layout: planar ``(B, C, H, W)`` sharded ``P("dp", None, "sp", None)`` —
uint8 end to end for uint8 inputs (halos cross the interconnect as raw
bytes, 4x less traffic than f32; conversion and rounding happen inside the
per-shard fused band step), float32 otherwise.

Each shard-local step is the *same fused band engine* as on one device
(``ops/fused.blur_fused_haloed``): the only distributed work is a halo
exchange of ``r`` raw input rows per shard boundary — ``jax.lax.ppermute``
shifts — before the kernel runs. Kernels wider than one shard
(``r > h_loc``) exchange whole blocks from ``ceil(r / h_loc)`` neighbors
(still O(r x W) nearest-neighbour traffic). The global top/bottom shards
synthesize their missing halo by reflect-101 — against the multi-shard
halo context when the reflection span crosses shard boundaries — so the
sharded result equals the single-device result up to float rounding for
every legal radius (r <= H - 1).

The reference's ``flip_block`` transpose between row/col passes
(``Source.cpp:367,384``) assumed one address space. Here the column pass
happens in place on each shard; no transpose, no gather, only O(r x W)
neighbour traffic.

When the radius passes the device's band-vs-FFT crossover, or the gather
would replicate ~the whole frame into every shard (r ~ H, where halo
context is inherently O(n_sp x frame) aggregate), the call reroutes to
:func:`blur_fft_sharded` — two ``all_to_all`` reshards move each element
exactly twice, O(frame) aggregate traffic, radius-free. All devices of a
host reach each other at the same rate (NVLink), so the mesh follows the
algorithm alone.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P

from blur_algorithms.ops.pad import reflect_101
from blur_algorithms.ops.plan import BlurPlan

__all__ = [
    "blur_sharded",
    "blur_sharded_u8",
    "blur_fft_sharded",
    "blur_fft_sharded_u8",
]


def _local_plan(plan: BlurPlan, h_loc: int, w: int) -> BlurPlan:
    """Per-shard plan: the GLOBAL taps on the local row count.

    Built by replacing the geometry rather than re-planning so the kernel is
    bit-identical to the single-chip plan even when the support exceeds the
    shard height (``make_plan`` would re-clamp the width to the shard).
    Only ``shape``/``taps``/``support_radius`` feed the fused kernel; the
    FFT-length fields keep the global plan's values and are unused here.
    """
    return dataclasses.replace(
        plan, shape=(h_loc, w), col=dataclasses.replace(plan.col, dim=h_loc)
    )


@functools.partial(jax.jit, static_argnames=("plan", "mesh", "out_u8"))
def blur_sharded(
    planar: jnp.ndarray, plan: BlurPlan, mesh: Mesh, out_u8: bool = False
) -> jnp.ndarray:
    """Blur planar frames ``(B, C, H, W)`` over a ``(dp, sp)`` mesh.

    uint8 input stays uint8 through the sharding constraint AND the halo
    exchange (4x less traffic than shipping f32 rows) and converts inside
    the per-shard fused band step; float input runs in float32. ``out_u8``
    rounds there and returns uint8 shards.
    """
    b, c, h, w = planar.shape
    if h != plan.shape[0] or w != plan.shape[1]:
        raise ValueError(f"plan shape {plan.shape} != image shape {(h, w)}")
    n_dp, n_sp = mesh.shape["dp"], mesh.shape["sp"]
    # indivisible batch/height: zero-pad up to the mesh grid and crop after.
    # The padded rows never leak into real outputs — the halo arithmetic
    # below reflects against the TRUE height, so every output row < h reads
    # exactly the rows the single-device blur would.
    pad_b = (-b) % n_dp
    pad_h = (-h) % n_sp
    if pad_b or pad_h:
        planar = jnp.pad(
            planar, [(0, pad_b), (0, 0), (0, pad_h), (0, 0)]
        )
    h_loc = (h + pad_h) // n_sp
    r = plan.col.support_radius
    local_plan = _local_plan(plan, h_loc, w)

    is_u8 = planar.dtype == jnp.uint8

    # Wide-radius routing (trace-time, plan static): past the device's
    # band-vs-FFT crossover (single-device AUTO takes the FFT there too),
    # or when the whole-block halo gather would replicate close to the
    # full frame into every shard, the distributed FFT — each element
    # moves exactly twice, radius-independent — takes over.
    if r > 0:
        from blur_algorithms.utils.hw import budgets

        spec_hw = budgets()
        r_max = (
            spec_hw.auto_fused_max_radius_u8 if is_u8
            else spec_hw.auto_fused_max_radius_f32
        )
        in_bytes = 1 if is_u8 else 4
        k = min(-(-r // h_loc), n_sp - 1)
        ctx_bytes = (
            ((b + pad_b) // n_dp) * c * (2 * k + 1) * h_loc * w * in_bytes
        )
        if r > r_max or ctx_bytes > spec_hw.split_hbm_budget // 2:
            if pad_b or pad_h:  # delegate the original, unpadded frames
                planar = planar[:b, :, :h, :]
            return blur_fft_sharded(planar, plan, mesh, out_u8=out_u8)
    spec = P("dp", None, "sp", None)
    planar = jax.lax.with_sharding_constraint(
        planar if is_u8 else planar.astype(jnp.float32),
        NamedSharding(mesh, spec),
    )

    from blur_algorithms.ops.fused import blur_fused_haloed

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(spec,),
        out_specs=spec,
    )
    def run(block):
        if r == 0:
            haloed = block
        elif n_sp == 1:
            haloed = reflect_101(block, [(r, r)], axes=[-2])
        elif r + 2 * pad_h + 1 <= h_loc:
            idx = jax.lax.axis_index("sp")
            if pad_h:
                # indivisible height: the bottom shard's zero-pad rows get
                # the reflect-101 continuation of the TRUE image (rows
                # h-2, h-3, ...) so edge-row halos stay geometrically
                # correct — keeping the cheap path instead of falling to
                # the whole-block gather for a few pad rows
                fill = block[
                    ..., h_loc - 2 * pad_h - 1 : h_loc - pad_h - 1, :
                ][..., ::-1, :]
                filled = jnp.concatenate(
                    [block[..., : h_loc - pad_h, :], fill], axis=-2
                )
                block = jnp.where(idx == n_sp - 1, filled, block)
            # interior halos: my edge rows -> my neighbors
            from_above = jax.lax.ppermute(
                block[..., -r:, :], "sp", [(i, i + 1) for i in range(n_sp - 1)]
            )
            from_below = jax.lax.ppermute(
                block[..., :r, :], "sp", [(i + 1, i) for i in range(n_sp - 1)]
            )
            # global borders: reflect-101 (row 0 / row -1 not repeated);
            # the bottom mirror continues past the filled pad rows, hence
            # the 2*pad_h shift of its source window
            reflect_top = block[..., 1 : r + 1, :][..., ::-1, :]
            lo = h_loc - 1 - 2 * pad_h - r
            reflect_bot = block[..., lo : lo + r, :][..., ::-1, :]
            top = jnp.where((idx == 0), reflect_top, from_above)
            bot = jnp.where((idx == n_sp - 1), reflect_bot, from_below)
            haloed = jnp.concatenate([top, block, bot], axis=-2)
        else:
            # kernel wider than a shard (or padded height): gather whole
            # blocks from the k nearest neighbors each way (absent sources
            # deliver zeros), then index the (2k+1)-block context with
            # reflect-101 row arithmetic against the TRUE height so
            # out-of-image rows pick up the mirrored data — which may
            # itself live in a neighbor's contribution. Outputs for the
            # zero-pad rows (>= h) are garbage and cropped by the caller.
            k = min(-(-r // h_loc), n_sp - 1)
            idx = jax.lax.axis_index("sp")
            above = [
                jax.lax.ppermute(
                    block, "sp", [(i, i + d) for i in range(n_sp - d)]
                )
                for d in range(k, 0, -1)
            ]
            below = [
                jax.lax.ppermute(
                    block, "sp", [(i + d, i) for i in range(n_sp - d)]
                )
                for d in range(1, k + 1)
            ]
            ext = jnp.concatenate(above + [block] + below, axis=-2)
            # ext row 0 is global row idx*h_loc - k*h_loc; plan clamping
            # guarantees r <= h - 1, so one reflection always lands inside
            # for every REAL output row; the final clip only matters for
            # the cropped pad rows, whose reflection can escape the image
            g = idx * h_loc + jnp.arange(-r, h_loc + r)
            g = jnp.where(g < 0, -g, g)
            g = jnp.where(g > h - 1, 2 * (h - 1) - g, g)
            g = jnp.clip(g, 0, h - 1)
            haloed = jnp.take(ext, g - (idx - k) * h_loc, axis=-2)
        return blur_fused_haloed(haloed, local_plan, out_u8=out_u8)

    out = run(planar)
    if pad_b or pad_h:
        out = out[:b, :, :h, :]
    return out


def blur_sharded_u8(img: jnp.ndarray, plan: BlurPlan, mesh: Mesh) -> jnp.ndarray:
    """uint8 frames ``(B, H, W, C)`` in -> uint8 out, sharded pipeline.

    uint8 end to end: halos cross as raw bytes, conversion and rounding
    happen inside the per-shard fused band step.
    """
    planar = jnp.moveaxis(img, -1, -3)
    out = blur_sharded(planar, plan, mesh, out_u8=True)
    return jnp.moveaxis(out, -3, -1)


@functools.partial(jax.jit, static_argnames=("plan", "mesh", "out_u8"))
def blur_fft_sharded(
    planar: jnp.ndarray, plan: BlurPlan, mesh: Mesh, out_u8: bool = False
) -> jnp.ndarray:
    """FFT-engine blur of planar ``(B, C, H, W)`` over a ``(dp, sp)`` mesh.

    The classic distributed-FFT decomposition (the scaling-book recipe:
    pick a mesh, place explicit collectives where the layout flips): the
    rows pass transforms axis -1 with H sharded over ``sp`` — every row
    lives whole on one device, so the batched rFFT runs shard-local — then
    one ``all_to_all`` flips the layout to W-sharded and the
    columns pass transforms axis -2 the same way, followed by the inverse
    flip. No halo exchange exists because the FFT consumes the full axis,
    and no device ever holds a full frame. Semantics are identical to
    ``fft_tiles`` (same pads/spectra/crops, ``ops/fft_conv._tile_pass``).
    Indivisible B/H/W pad-and-crop like :func:`blur_sharded`.
    """
    from blur_algorithms.ops.fft_conv import _tile_pass
    from blur_algorithms.ops.layout import round_to_u8

    b, c, h, w = planar.shape
    if h != plan.shape[0] or w != plan.shape[1]:
        raise ValueError(f"plan shape {plan.shape} != image shape {(h, w)}")
    n_dp, n_sp = mesh.shape["dp"], mesh.shape["sp"]
    # pad-and-crop for indivisible shapes. Each 1-D pass slices its conv
    # axis back to the TRUE length first (the zero-pad must not feed the
    # reflect border) and re-pads after — pad rows/cols are then extra
    # independent rows of the batched FFT that never mix with real data.
    pad_b, pad_h, pad_w = (-b) % n_dp, (-h) % n_sp, (-w) % n_sp
    if pad_b or pad_h or pad_w:
        planar = jnp.pad(
            planar, [(0, pad_b), (0, 0), (0, pad_h), (0, pad_w)]
        )

    spec = P("dp", None, "sp", None)

    @functools.partial(
        jax.shard_map, mesh=mesh, in_specs=(spec,), out_specs=spec,
    )
    def run(block):
        y = _tile_pass(block[..., :w].astype(jnp.float32), plan.row, -1)
        if pad_w:
            y = jnp.pad(y, [(0, 0)] * 3 + [(0, pad_w)])
        if n_sp > 1:  # H-sharded -> W-sharded: one all-to-all
            y = jax.lax.all_to_all(
                y, "sp", split_axis=3, concat_axis=2, tiled=True
            )
        y = _tile_pass(y[..., :h, :], plan.col, -2)
        if pad_h:
            y = jnp.pad(y, [(0, 0), (0, 0), (0, pad_h), (0, 0)])
        if n_sp > 1:  # and back
            y = jax.lax.all_to_all(
                y, "sp", split_axis=2, concat_axis=3, tiled=True
            )
        return round_to_u8(y) if out_u8 else y

    out = run(planar)
    if pad_b or pad_h or pad_w:
        out = out[:b, :, :h, :w]
    return out


def blur_fft_sharded_u8(
    img: jnp.ndarray, plan: BlurPlan, mesh: Mesh
) -> jnp.ndarray:
    """uint8 frames ``(B, H, W, C)`` through the sharded FFT pipeline."""
    planar = jnp.moveaxis(img, -1, -3)
    out = blur_fft_sharded(planar, plan, mesh, out_u8=True)
    return jnp.moveaxis(out, -3, -1)
