"""The README quick-start snippets must run exactly as written."""

import jax.numpy as jnp
import numpy as np


def test_library_quickstart(rng):
    img_u8_hwc = jnp.asarray((rng.random((64, 48, 3)) * 255).astype(np.uint8))

    from blur_algorithms import gaussian_blur, box_blur, dft_spectrum

    out = gaussian_blur(img_u8_hwc, sigma=10.0)
    assert out.shape == img_u8_hwc.shape
    out = gaussian_blur(img_u8_hwc, 10.0, engine="fft2")
    assert out.dtype == jnp.uint8
    out = box_blur(img_u8_hwc, 3.0)
    assert out.shape == img_u8_hwc.shape
    spec = dft_spectrum(img_u8_hwc, 1.0)
    assert spec.shape[0] == 3


def test_multichip_quickstart(rng):
    batch_u8_bhwc = jnp.asarray((rng.random((8, 128, 48, 3)) * 255).astype(np.uint8))
    hw = (128, 48)

    from blur_algorithms.parallel import make_mesh, blur_sharded_u8
    from blur_algorithms.ops.plan import make_plan

    mesh = make_mesh(dp=4, sp=2)
    out = blur_sharded_u8(batch_u8_bhwc, make_plan(hw, 10.0), mesh)
    assert out.shape == batch_u8_bhwc.shape


def test_pipeline_warmup(rng):
    from blur_algorithms.models import GaussianBlur

    pipe = GaussianBlur(2.0, bucket=64)
    pipe.warmup([(50, 60), (100, 110)])
    assert pipe.stats["calls"] == 0
    assert pipe.stats["distinct_buckets"] == 2
    out = pipe(jnp.asarray((rng.random((50, 60, 3)) * 255).astype(np.uint8)))
    assert out.shape == (50, 60, 3)
    assert pipe.stats["distinct_buckets"] == 2  # no new compile
