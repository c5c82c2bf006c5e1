"""Edge-shape robustness across engines: tiny/skinny images, channel counts,
batch dims, degenerate sigmas. Every case must produce a finite result of
the right shape (the reference crashes or reads out of bounds on several)."""

import jax.numpy as jnp
import numpy as np
import pytest

from blur_algorithms import Engine, blur, blur_u8, box_blur

ENGINES = [Engine.FFT2, Engine.FFT_TILES, Engine.BAND, Engine.FUSED]


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize(
    "shape", [(1, 1), (1, 64), (64, 1), (2, 2), (5, 200), (200, 5)]
)
def test_degenerate_shapes(rng, engine, shape):
    img = (rng.random(shape + (3,)) * 255).astype(np.uint8)
    out = np.asarray(blur_u8(jnp.asarray(img), 4.0, engine=engine))
    assert out.shape == img.shape
    assert np.isfinite(out.astype(np.float64)).all()


@pytest.mark.parametrize("channels", [1, 2, 4])
def test_channel_counts(rng, channels):
    img = (rng.random((32, 40, channels)) * 255).astype(np.uint8)
    out = np.asarray(blur_u8(jnp.asarray(img), 3.0))
    assert out.shape == img.shape
    # channels are independent: channel 0 of a C-channel blur == C=1 blur
    single = np.asarray(blur_u8(jnp.asarray(img[..., :1]), 3.0))
    np.testing.assert_array_equal(out[..., :1], single)


def test_deep_batch_dims(rng):
    imgs = (rng.random((2, 3, 24, 28, 3)) * 255).astype(np.uint8)
    out = np.asarray(blur_u8(jnp.asarray(imgs), 2.0))
    assert out.shape == imgs.shape
    one = np.asarray(blur_u8(jnp.asarray(imgs[1, 2]), 2.0))
    np.testing.assert_array_equal(out[1, 2], one)


def test_tiny_sigma():
    img = np.full((16, 16, 3), 100, np.uint8)
    out = np.asarray(blur_u8(jnp.asarray(img), 0.01))
    np.testing.assert_array_equal(out, img)


def test_huge_sigma_on_tiny_image(rng):
    img = (rng.random((8, 8, 3)) * 255).astype(np.uint8)
    out = np.asarray(blur_u8(jnp.asarray(img), 1000.0))
    assert out.shape == img.shape
    assert np.isfinite(out.astype(np.float64)).all()


def test_box_on_tiny_image(rng):
    img = (rng.random((4, 4, 3)) * 255).astype(np.uint8)
    out = np.asarray(box_blur(jnp.asarray(img), 10.0))  # radius 100 >> image
    assert out.shape == img.shape


def test_float_planar_non_contiguous_batch(rng):
    x = rng.random((4, 2, 30, 34)).astype(np.float32)
    out = np.asarray(blur(jnp.asarray(x), 2.5, engine=Engine.BAND))
    assert out.shape == x.shape
    one = np.asarray(blur(jnp.asarray(x[2]), 2.5, engine=Engine.BAND))
    np.testing.assert_allclose(out[2], one, atol=1e-4)


def test_engine_string_names():
    img = jnp.zeros((16, 16, 3), jnp.uint8)
    for name in ["fft2", "fft_tiles", "band", "fused", "auto", "conv"]:
        out = blur_u8(img, 2.0, engine=name)
        assert out.shape == img.shape


def test_bfloat16_planar_input(rng):
    import jax.numpy as jnp

    x = jnp.asarray(rng.random((2, 40, 48)).astype(np.float32)).astype(jnp.bfloat16)
    out = np.asarray(blur(x, 3.0, engine=Engine.BAND))
    assert out.dtype == np.float32
    want = np.asarray(blur(x.astype(jnp.float32), 3.0, engine=Engine.BAND))
    np.testing.assert_allclose(out, want, atol=2e-2)  # bf16 input quantization
