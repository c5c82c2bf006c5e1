"""Deriche recursive-Gaussian engine: oracle parity, gating, API routing.

The engine approximates the reference's truncated Gaussian
(``Source.cpp:60-102``) with Deriche's 4th-order recursive form; the
certification gate is the framework-wide <=1 uint8 count vs the CPU
pocketfft oracle (``oracle.blur_planar_fft2``).
"""

import numpy as np
import pytest

from blur_algorithms import api, oracle
from blur_algorithms.ops import deriche
from blur_algorithms.ops.plan import make_plan


@pytest.fixture(scope="module")
def frame():
    rng = np.random.default_rng(7)
    return rng.integers(0, 256, (3, 320, 288), dtype=np.uint8)


def _oracle_u8(planar_u8, sigma):
    plan = make_plan(planar_u8.shape[-2:], sigma)
    ref = oracle.blur_planar_fft2(planar_u8.astype(np.float32), plan)
    return ref, np.clip(np.floor(ref + 0.5), 0, 255).astype(np.uint8)


@pytest.mark.parametrize("sigma", [16.0, 40.0])
def test_u8_parity_vs_oracle(frame, sigma):
    out = np.asarray(deriche.blur_deriche_u8(frame, sigma))
    _, ref_u8 = _oracle_u8(frame, sigma)
    err = np.abs(out.astype(int) - ref_u8.astype(int))
    assert err.max() <= 1
    # the approximation is tight, not merely within the rounding gate
    assert (err > 0).mean() < 0.02


def test_f32_parity_vs_oracle(frame):
    sigma = 24.0
    out = np.asarray(deriche.blur_deriche(frame.astype(np.float32), sigma))
    ref, _ = _oracle_u8(frame, sigma)
    assert np.abs(out - ref).max() < 0.1


def test_taps_match_truncated_gaussian():
    # near-field taps track the reference's sampled Gaussian closely
    from blur_algorithms.ops.kernels import gaussian_kernel, gaussian_window

    sigma = 20.0
    taps = deriche.deriche_taps(sigma)
    width = gaussian_window(sigma, 10_000)
    ref = gaussian_kernel(sigma, width)
    r = (width - 1) // 2
    rb = (taps.shape[0] - 1) // 2
    lo = min(r, rb)
    a = taps[rb - lo : rb + lo + 1]
    b = ref[r - lo : r + lo + 1]
    assert np.abs(a - b).sum() + abs(1 - taps.sum()) < 1.5 / 255


def test_applicability_gate():
    assert not deriche.deriche_applicable((320, 288), 10.0)  # sigma < 16
    assert not deriche.deriche_applicable((160, 128), 16.0)  # pad > dim - 1
    assert deriche.deriche_applicable((320, 288), 16.0)
    # 4.75*sigma one-side pad must fit in dim - 1
    assert not deriche.deriche_applicable((400, 400), 90.0)
    with pytest.raises(ValueError, match="not applicable"):
        deriche.blur_deriche_u8(np.zeros((3, 64, 64), np.uint8), 16.0)


def test_api_explicit_engine(frame):
    img = np.moveaxis(frame, 0, -1)  # interleaved (H, W, C)
    out = np.asarray(api.blur_u8(img, 16.0, engine="deriche"))
    direct = np.asarray(deriche.blur_deriche_u8(frame, 16.0))
    np.testing.assert_array_equal(out, np.moveaxis(direct, 0, -1))


def test_api_rejects_non_gaussian():
    img = np.zeros((320, 288, 3), np.uint8)
    with pytest.raises(ValueError, match="gaussian"):
        api.blur_u8(img, 16.0, engine="deriche", kernel="box")


def test_auto_never_routes_deriche():
    # deriche is an explicit engine: AUTO never routes it, at any radius
    for shape, sigma in [((4000, 3000), 260.0), ((5120, 5120), 1000.0)]:
        plan = make_plan(shape, sigma)
        for in_bytes in (1, 4):
            assert (
                api._resolve_engine(api.Engine.AUTO, plan, in_bytes)
                is not api.Engine.DERICHE
            )


def test_differentiable(frame):
    # tails are plain XLA (einsum/scan); the band inherits the fused
    # kernel's custom_vjp — grad flows end to end for float inputs
    import jax
    import jax.numpy as jnp

    x = jnp.asarray(frame[:1, :, :].astype(np.float32))

    def loss(v):
        return jnp.sum(deriche.blur_deriche(v, 16.0) ** 2)

    g = jax.grad(loss)(x)
    assert np.isfinite(np.asarray(g)).all()
    assert float(jnp.abs(g).max()) > 0


def test_batch_dims(frame):
    sigma = 16.0
    batched = np.stack([frame, frame[::-1]], axis=0)  # (2, 3, H, W)
    out = np.asarray(deriche.blur_deriche_u8(batched, sigma))
    a = np.asarray(deriche.blur_deriche_u8(batched[0], sigma))
    np.testing.assert_array_equal(out[0], a)
    assert out.shape == batched.shape
