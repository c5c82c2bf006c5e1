"""Adjoint correctness and differentiability of the engines."""

import jax
import jax.numpy as jnp
import numpy as np

from blur_algorithms.ops.adjoint import blur_adjoint
from blur_algorithms.ops.band_matmul import blur_band_matmul
from blur_algorithms.ops.plan import make_plan
from blur_algorithms.ops.fused import blur_fused


def test_adjoint_identity(rng):
    """<A x, y> == <x, A^T y> for the blur operator A."""
    plan = make_plan((20, 26), 3.0)
    x = rng.random((20, 26)).astype(np.float32)
    y = rng.random((20, 26)).astype(np.float32)
    ax = np.asarray(blur_band_matmul(jnp.asarray(x), plan))
    aty = np.asarray(blur_adjoint(jnp.asarray(y), plan))
    lhs = float(np.sum(ax.astype(np.float64) * y))
    rhs = float(np.sum(x.astype(np.float64) * aty))
    assert abs(lhs - rhs) < 1e-2 * max(abs(lhs), 1.0)


def test_adjoint_identity_clamped_pad(rng):
    # radius clamped by the small axis: the fold must still be exact
    plan = make_plan((7, 40), 8.0)
    x = rng.random((7, 40)).astype(np.float32)
    y = rng.random((7, 40)).astype(np.float32)
    ax = np.asarray(blur_band_matmul(jnp.asarray(x), plan))
    aty = np.asarray(blur_adjoint(jnp.asarray(y), plan))
    lhs = float(np.sum(ax.astype(np.float64) * y))
    rhs = float(np.sum(x.astype(np.float64) * aty))
    assert abs(lhs - rhs) < 1e-2 * max(abs(lhs), 1.0)


def test_fused_vjp_matches_band_autodiff(rng):
    plan = make_plan((24, 32), 2.0)
    x = jnp.asarray(rng.random((2, 24, 32)).astype(np.float32))
    ct = jnp.asarray(rng.random((2, 24, 32)).astype(np.float32))

    _, vjp_fused = jax.vjp(lambda v: blur_fused(v, plan), x)
    _, vjp_band = jax.vjp(lambda v: blur_band_matmul(v, plan), x)
    (g_fused,) = vjp_fused(ct)
    (g_band,) = vjp_band(ct)
    np.testing.assert_allclose(
        np.asarray(g_fused), np.asarray(g_band), atol=2e-3
    )


def test_grad_through_blur_scalar_loss(rng):
    plan = make_plan((16, 16), 1.5)
    x = jnp.asarray(rng.random((16, 16)).astype(np.float32))

    def loss(v):
        return jnp.sum(blur_fused(v, plan) ** 2)

    g = jax.grad(loss)(x)
    assert g.shape == x.shape
    # numerical check on one coordinate
    eps = 1e-3
    e = jnp.zeros_like(x).at[8, 8].set(eps)
    num = (loss(x + e) - loss(x - e)) / (2 * eps)
    assert abs(float(g[8, 8]) - float(num)) < 5e-2 * max(abs(float(num)), 1.0)


def test_jnp_engines_autodiff(rng):
    from blur_algorithms.ops.fft_conv import blur_fft_tiles

    plan = make_plan((16, 20), 2.0)
    x = jnp.asarray(rng.random((16, 20)).astype(np.float32))
    g = jax.grad(lambda v: jnp.sum(blur_fft_tiles(v, plan)))(x)
    assert np.isfinite(np.asarray(g)).all()


def test_adjointness_wide_radius(rng):
    """<blur(x), y> == <x, adjoint(y)> on the wide-kernel FFT adjoint path."""
    import jax

    from blur_algorithms.ops.adjoint import blur_adjoint
    from blur_algorithms.ops.fft_mxu import blur_fft_mxu
    from blur_algorithms.ops.plan import make_plan

    h, w, sigma = 8, 2100, 400.0
    plan = make_plan((h, w), sigma)
    assert plan.row.support_radius > 1024  # exercises _valid_conv_wide
    x = jnp.asarray(rng.standard_normal((h, w)).astype(np.float32))
    y = jnp.asarray(rng.standard_normal((h, w)).astype(np.float32))
    bx = blur_fft_mxu(x, plan, precision=jax.lax.Precision.HIGHEST)
    aty = blur_adjoint(y, plan)
    lhs = float(jnp.vdot(bx, y))
    rhs = float(jnp.vdot(x, aty))
    assert abs(lhs - rhs) < 1e-2 * max(1.0, abs(lhs))


import pytest

# every public engine: <blur(x), y> == <x, grad_x <blur(x), y>> (linearity)
_GRAD_ENGINES = [
    "fft2", "fft_tiles", "conv", "band", "fused", "fft_mxu",
    "fft_stream", "box_scan", "box", "cascade", "auto",
]


@pytest.mark.parametrize("engine", _GRAD_ENGINES)
def test_engine_grad_matrix(engine, rng):
    """jax.grad works through EVERY engine (README's differentiability claim).

    For a linear operator A, grad_x <A x, y> = A^T y, so the adjoint
    identity <A x, y> == <x, A^T y> verifies both that grad runs and that
    the VJP is the true adjoint.
    """
    from blur_algorithms.api import blur

    x = jnp.asarray(rng.random((18, 22)).astype(np.float32))
    y = jnp.asarray(rng.random((18, 22)).astype(np.float32))
    nsmooth = 2.0  # box engines read this as radius = 4, 2 passes

    def f(v):
        return blur(v, nsmooth, engine=engine)

    bx = f(x)
    g = jax.grad(lambda v: jnp.vdot(f(v), y))(x)
    assert g.shape == x.shape and np.isfinite(np.asarray(g)).all()
    lhs = float(jnp.vdot(bx, y))
    rhs = float(jnp.vdot(x, g))
    assert abs(lhs - rhs) < 1e-2 * max(abs(lhs), 1.0), (engine, lhs, rhs)


def test_box_scan_grad_matches_band_autodiff(rng):
    """Autodiff through the cumsum box scan equals autodiff through the
    band engine on the folded taps."""
    from blur_algorithms.ops.box_blur import box_blur_scan
    from blur_algorithms.ops.plan import make_plan

    r, passes = 3, 2
    x = jnp.asarray(rng.random((20, 28)).astype(np.float32))
    ct = jnp.asarray(rng.random((20, 28)).astype(np.float32))
    plan = make_plan((20, 28), r, kernel="box_fast", box_passes=passes)

    _, vjp_scan = jax.vjp(lambda v: box_blur_scan(v, r, passes), x)
    _, vjp_band = jax.vjp(lambda v: blur_band_matmul(v, plan), x)
    (g_scan,) = vjp_scan(ct)
    (g_band,) = vjp_band(ct)
    np.testing.assert_allclose(
        np.asarray(g_scan), np.asarray(g_band), atol=2e-3
    )


def test_streamed_grad_matches_tiles_autodiff(rng):
    from blur_algorithms.ops.fft_conv import blur_fft_tiles
    from blur_algorithms.ops.plan import make_plan
    from blur_algorithms.ops.streamed import blur_fft_tiles_streamed

    plan = make_plan((24, 40), 3.0)
    x = jnp.asarray(rng.random((24, 40)).astype(np.float32))
    ct = jnp.asarray(rng.random((24, 40)).astype(np.float32))
    _, vjp_s = jax.vjp(lambda v: blur_fft_tiles_streamed(v, plan, 16), x)
    _, vjp_t = jax.vjp(lambda v: blur_fft_tiles(v, plan), x)
    (g_s,) = vjp_s(ct)
    (g_t,) = vjp_t(ct)
    np.testing.assert_allclose(np.asarray(g_s), np.asarray(g_t), atol=2e-3)
