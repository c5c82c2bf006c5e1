"""Strip-streamed FFT engine: equality with the whole-image path + routing."""

import jax.numpy as jnp
import numpy as np

from blur_algorithms import Engine
from blur_algorithms.api import _resolve_engine
from blur_algorithms.ops.fft_conv import blur_fft_tiles
from blur_algorithms.ops.plan import make_plan
from blur_algorithms.ops.streamed import (
    blur_fft_tiles_streamed,
    estimate_fft_tiles_bytes,
)


def test_streamed_equals_whole_image(rng):
    x = rng.random((3, 70, 90)).astype(np.float32) * 255
    plan = make_plan((70, 90), 6.0)
    whole = np.asarray(blur_fft_tiles(jnp.asarray(x), plan))
    for strip in [16, 64, 128]:
        streamed = np.asarray(
            blur_fft_tiles_streamed(jnp.asarray(x), plan, strip=strip)
        )
        np.testing.assert_allclose(streamed, whole, atol=1e-3)


def test_strip_not_dividing_rows(rng):
    x = rng.random((1, 33, 47)).astype(np.float32)
    plan = make_plan((33, 47), 2.0)
    whole = np.asarray(blur_fft_tiles(jnp.asarray(x), plan))
    streamed = np.asarray(blur_fft_tiles_streamed(jnp.asarray(x), plan, strip=10))
    np.testing.assert_allclose(streamed, whole, atol=1e-3)


def test_memory_estimate_scales():
    small = make_plan((1080, 1920), 10.0)
    giant = make_plan((24000, 14500), 155.0)
    assert estimate_fft_tiles_bytes(small) < estimate_fft_tiles_bytes(giant)
    assert estimate_fft_tiles_bytes(giant) > 4 << 30


def test_auto_routing_by_radius_and_size():
    # r ~ 514 at 348 MP: past the band crossover, and one RGB frame's
    # transform intermediates fit the device budget -> whole-frame FFT
    giant = make_plan((24000, 14500), 155.0)
    assert _resolve_engine(Engine.AUTO, giant) is Engine.FFT_TILES
    # a batch of 8 such frames does not fit -> strip-streamed FFT
    assert _resolve_engine(Engine.AUTO, giant, lead=24) is Engine.FFT_STREAM
    normal = make_plan((1080, 1920), 10.0)
    assert _resolve_engine(Engine.AUTO, normal) is Engine.FUSED


def test_strip_larger_than_axis(rng):
    """strip > the sliced axis: clamps to one whole strip (no pad copy)."""
    from blur_algorithms.ops.streamed import blur_fft_tiles_streamed_u8
    from blur_algorithms import oracle

    img = (rng.random((40, 56, 3)) * 255).astype(np.uint8)
    plan = make_plan((40, 56), 4.0)
    planar = jnp.moveaxis(jnp.asarray(img), -1, -3)
    got = np.asarray(blur_fft_tiles_streamed_u8(planar, plan, strip=512))
    want = np.moveaxis(oracle.blur_u8(img, 4.0), -1, 0)
    assert int(np.abs(got.astype(int) - want.astype(int)).max()) <= 1


def test_clamped_last_strip_overlap(rng):
    """Non-dividing strip: the clamped last strip rewrites overlap rows
    with identical values (u8 path, both axes)."""
    from blur_algorithms.ops.streamed import blur_fft_tiles_streamed_u8
    from blur_algorithms import oracle

    img = (rng.random((53, 47, 3)) * 255).astype(np.uint8)
    plan = make_plan((53, 47), 3.0)
    planar = jnp.moveaxis(jnp.asarray(img), -1, -3)
    got = np.asarray(blur_fft_tiles_streamed_u8(planar, plan, strip=16))
    want = np.moveaxis(oracle.blur_u8(img, 3.0), -1, 0)
    assert int(np.abs(got.astype(int) - want.astype(int)).max()) <= 1
