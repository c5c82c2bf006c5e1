"""Per-channel smoothing recipes (reference 'Clean Up Comparisons' workflow)."""

import numpy as np
import pytest

from blur_algorithms import oracle
from blur_algorithms.models.channel_smooth import channel_smooth


def test_rgb_recipe_per_channel(rgb_image):
    out = channel_smooth(rgb_image, (1.0, 11.0, 11.0))
    assert out.shape == rgb_image.shape and out.dtype == np.uint8
    # the lightly-smoothed channel keeps more variance than the heavy ones
    assert out[..., 0].std() > out[..., 1].std()


def test_zero_sigma_leaves_channel_untouched(rgb_image):
    out = channel_smooth(rgb_image, (0, 5.0, None))
    np.testing.assert_array_equal(out[..., 0], rgb_image[..., 0])
    np.testing.assert_array_equal(out[..., 2], rgb_image[..., 2])
    assert (out[..., 1] != rgb_image[..., 1]).any()


def test_rgb_matches_oracle_per_channel(rgb_image):
    out = channel_smooth(rgb_image, (5.0, 5.0, 5.0))
    want = oracle.blur_u8(rgb_image, 5.0)
    assert np.abs(out.astype(int) - want.astype(int)).max() <= 1


def test_lab_recipe_roundtrip(rgb_image):
    cv2 = pytest.importorskip("cv2")
    out = channel_smooth(rgb_image, (5.0, 5.0, 7.0), colorspace="lab")
    assert out.shape == rgb_image.shape
    # chroma smoothing shouldn't shift overall lightness much
    lab_in = cv2.cvtColor(rgb_image, cv2.COLOR_RGB2Lab)
    lab_out = cv2.cvtColor(out, cv2.COLOR_RGB2Lab)
    assert abs(float(lab_in[..., 0].mean()) - float(lab_out[..., 0].mean())) < 2.0


def test_bad_inputs(rgb_image):
    with pytest.raises(ValueError):
        channel_smooth(rgb_image.astype(np.float32), (1, 1, 1))
    with pytest.raises(ValueError):
        channel_smooth(rgb_image, (1, 1))
    with pytest.raises(ValueError):
        channel_smooth(rgb_image, (1, 1, 1), colorspace="hsv")


def test_single_program_per_recipe(rng):
    """The whole recipe compiles once per (shape, sigmas) — no host hops."""
    import importlib

    cs = importlib.import_module("blur_algorithms.models.channel_smooth")

    cs._compiled_recipe.cache_clear()
    img = (rng.random((32, 40, 3)) * 255).astype(np.uint8)
    a = cs.channel_smooth(img, (1.0, 2.0, 3.0))
    b = cs.channel_smooth(img, (1.0, 2.0, 3.0))
    info = cs._compiled_recipe.cache_info()
    assert info.misses == 1 and info.hits == 1
    np.testing.assert_array_equal(a, b)


def test_zero_sigma_channel_untouched_fused_program(rng):
    from blur_algorithms.models.channel_smooth import channel_smooth

    img = (rng.random((24, 24, 3)) * 255).astype(np.uint8)
    out = channel_smooth(img, (0, 5.0, None))
    np.testing.assert_array_equal(out[..., 0], img[..., 0])
    np.testing.assert_array_equal(out[..., 2], img[..., 2])
    assert not np.array_equal(out[..., 1], img[..., 1])
