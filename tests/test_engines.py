"""The engines vs the CPU pocketfft oracle and vs each other."""

import jax.numpy as jnp
import numpy as np
import pytest

from blur_algorithms import Engine, blur, blur_u8, box_blur, oracle
from blur_algorithms.ops.box_blur import box_blur_planar
from blur_algorithms.ops.plan import make_plan

SIGMAS = [2.0, 10.0, 50.0]
ENGINES = [Engine.FFT2, Engine.FFT_TILES, Engine.CONV, Engine.BAND, Engine.FUSED]


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("sigma", SIGMAS)
def test_engine_matches_oracle_u8(rgb_image, engine, sigma):
    got = np.asarray(blur_u8(jnp.asarray(rgb_image), sigma, engine=engine))
    want = oracle.blur_u8(rgb_image, sigma)
    diff = np.abs(got.astype(int) - want.astype(int))
    # float32 FFT accumulation-order differences can flip a rounding boundary
    assert diff.max() <= 1
    assert (diff == 0).mean() > 0.98


@pytest.mark.parametrize("engine", ENGINES)
def test_engine_matches_oracle_float(rng, engine):
    x = rng.random((3, 41, 57)).astype(np.float32) * 255
    plan = make_plan((41, 57), 6.0)
    want = oracle.blur_direct(x, plan)
    got = np.asarray(blur(jnp.asarray(x), 6.0, engine=engine))
    np.testing.assert_allclose(got, want, atol=5e-3)


def test_engines_agree_with_each_other(rgb_image):
    outs = [
        np.asarray(blur_u8(jnp.asarray(rgb_image), 7.5, engine=e)).astype(int)
        for e in ENGINES
    ]
    for other in outs[1:]:
        assert np.abs(outs[0] - other).max() <= 1


def test_pow2_size_mode_same_result(rgb_image):
    a = np.asarray(blur_u8(jnp.asarray(rgb_image), 5.0, engine=Engine.FFT_TILES))
    b = np.asarray(
        blur_u8(
            jnp.asarray(rgb_image), 5.0, engine=Engine.FFT_TILES, size_mode="pow2"
        )
    )
    assert np.abs(a.astype(int) - b.astype(int)).max() <= 1


def test_batched_matches_single(rgb_image):
    batch = jnp.stack([jnp.asarray(rgb_image)] * 3)
    got = np.asarray(blur_u8(batch, 4.0, engine=Engine.CONV))
    single = np.asarray(blur_u8(jnp.asarray(rgb_image), 4.0, engine=Engine.CONV))
    for b in range(3):
        np.testing.assert_array_equal(got[b], single)


def test_extreme_sigma_clamped(rgb_image):
    # sigma so large the window clamps to the max dim; must not crash
    out = np.asarray(blur_u8(jnp.asarray(rgb_image), 500.0, engine=Engine.FFT2))
    assert out.shape == rgb_image.shape
    # a huge blur approaches a constant image
    assert np.asarray(out).std() < rgb_image.std() / 4


def test_elongated_image_per_axis_clamp(rng):
    # H >> W: the reference's global window overflows the short axis; our
    # per-axis clamp must keep it legal and close to the direct oracle.
    x = (rng.random((200, 12, 3)) * 255).astype(np.uint8)
    out = np.asarray(blur_u8(jnp.asarray(x), 30.0, engine=Engine.FFT_TILES))
    assert out.shape == x.shape
    plan = make_plan((200, 12), 30.0)
    assert plan.row.pad <= 11
    want = oracle.blur_direct(
        np.moveaxis(x, -1, 0).astype(np.float32), plan
    )
    got = np.moveaxis(out.astype(np.float64), -1, 0)
    assert np.abs(got - want).max() <= 1.0


class TestBoxBlur:
    def _naive_box_1d(self, x, r):
        padded = oracle.reflect_101_np(x.astype(np.float64), [(r, r)], axes=[-1])
        n = x.shape[-1]
        out = np.zeros_like(x, dtype=np.float64)
        for t in range(2 * r + 1):
            out += padded[..., t : t + n]
        return out / (2 * r + 1)

    def test_single_axis_matches_naive(self, rng):
        x = rng.random((5, 40)).astype(np.float32) * 255
        from blur_algorithms.ops.box_blur import box_blur_axis

        got = np.asarray(box_blur_axis(jnp.asarray(x), 4, -1))
        np.testing.assert_allclose(got, self._naive_box_1d(x, 4), atol=1e-2)

    def test_two_passes(self, rng):
        x = rng.random((24, 30)).astype(np.float32) * 255
        got = np.asarray(box_blur_planar(jnp.asarray(x), 3, passes=2))
        want = x.astype(np.float64)
        for _ in range(2):
            want = self._naive_box_1d(want, 3)
            want = np.swapaxes(self._naive_box_1d(np.swapaxes(want, -1, -2), 3), -1, -2)
        np.testing.assert_allclose(got, want, atol=1e-2)

    def test_u8_api_reference_call_site(self, rgb_image):
        # Source.cpp:587: radius = nsmooth^2, passes=2
        out = np.asarray(box_blur(jnp.asarray(rgb_image), 2.0))
        assert out.shape == rgb_image.shape and out.dtype == np.uint8
        assert out.std() < rgb_image.std()

    def test_radius_clamp(self):
        x = jnp.ones((4, 5), dtype=jnp.float32)
        out = np.asarray(box_blur_planar(x, 100, passes=1))
        np.testing.assert_allclose(out, 1.0, atol=1e-5)
