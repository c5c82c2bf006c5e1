"""Arbitrary separable filters (beyond the reference's blur kernels).

``convolve_separable`` applies any odd-length 1-D taps per axis with the
same engine lattice, reflect-101 borders, and correlation semantics as the
blurs. Oracles: ``oracle.blur_direct`` (naive f64 correlation with
reflect-101 pad) on a custom plan, and hand-rolled numpy for the signed
cases.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from blur_algorithms import Engine, convolve_separable, oracle
from blur_algorithms.ops.plan import make_custom_plan

SHARPEN = np.array([-0.25, 1.5, -0.25], np.float32)  # symmetric, sum 1
TENT = np.array([0.25, 0.5, 0.25], np.float32)  # non-negative, sum 1
DERIV = np.array([-0.5, 0.0, 0.5], np.float32)  # antisymmetric, sum 0


class TestMakeCustomPlan:
    def test_basic(self):
        plan = make_custom_plan((32, 48), SHARPEN, TENT)
        assert plan.kernel == "custom"
        np.testing.assert_array_equal(plan.row.taps, SHARPEN)
        np.testing.assert_array_equal(plan.col.taps, TENT)
        assert plan.row.support_radius == 1 and plan.col.support_radius == 1

    def test_col_defaults_to_row(self):
        plan = make_custom_plan((16, 16), TENT)
        np.testing.assert_array_equal(plan.col.taps, TENT)

    def test_validation(self):
        with pytest.raises(ValueError):
            make_custom_plan((16, 16), np.ones(4, np.float32))  # even
        with pytest.raises(ValueError):
            make_custom_plan((16, 16), np.array([1.0, np.nan, 1.0]))

    def test_too_wide_taps_centrally_truncated(self):
        taps = np.arange(11, dtype=np.float32)
        plan = make_custom_plan((3, 64), np.ones(3, np.float32) / 3, taps)
        # col axis dim 3 allows width <= 2*(3-1)+1 = 5: center cut [3..7]
        np.testing.assert_array_equal(plan.col.taps, taps[3:8])
        # no renormalization for custom taps
        assert abs(float(plan.col.taps.sum()) - taps[3:8].sum()) < 1e-6

class TestConvolveSeparable:
    def test_sharpen_float_matches_oracle(self, rng):
        x = (rng.random((2, 40, 56)) * 255).astype(np.float32)
        got = np.asarray(convolve_separable(jnp.asarray(x), SHARPEN))
        plan = make_custom_plan((40, 56), SHARPEN)
        want = oracle.blur_direct(x, plan)
        np.testing.assert_allclose(got, want, atol=2e-2)

    def test_oracle_fft2_asymmetric_matches_direct(self, rng):
        # the np.fft oracle must carry the full complex correlation
        # spectrum for asymmetric plans, not just its real (symmetrized)
        # part — else it silently certifies the wrong operator
        x = (rng.random((2, 44, 52)) * 255).astype(np.float32)
        tr = np.array([0.2, 0.5, 0.9, -0.3, 0.1], np.float32)
        tc = np.array([-0.1, 0.8, 0.4], np.float32)
        plan = make_custom_plan((44, 52), tr, tc)
        assert not (plan.row.symmetric or plan.col.symmetric)
        got = oracle.blur_planar_fft2(x, plan)
        want = oracle.blur_direct(x, plan)
        np.testing.assert_allclose(got, want, atol=2e-3)

    def test_asymmetric_derivative_matches_numpy(self, rng):
        x = (rng.random((48, 40)) * 255).astype(np.float32)
        ident = np.array([1.0], np.float32)
        got = np.asarray(
            convolve_separable(jnp.asarray(x), DERIV, ident, engine="fused")
        )
        # correlation along rows with reflect-101 borders
        pad = np.pad(x, [(0, 0), (1, 1)], mode="reflect")
        want = -0.5 * pad[:, :-2] + 0.5 * pad[:, 2:]
        np.testing.assert_allclose(got, want, atol=2e-2)

    def test_u8_tent_int8_path(self, rgb_image):
        got = np.asarray(convolve_separable(jnp.asarray(rgb_image), TENT))
        plan = make_custom_plan(rgb_image.shape[:2], TENT)
        planar = np.moveaxis(rgb_image, -1, 0).astype(np.float64)
        want = np.clip(
            np.floor(oracle.blur_direct(planar, plan) + 0.5), 0, 255
        ).astype(np.uint8)
        d = np.abs(
            got.astype(int) - np.moveaxis(want, 0, -1).astype(int)
        )
        assert d.max() <= 1

    def test_u8_signed_sharpen_falls_back(self, rgb_image):
        """Signed taps hit <=1 count."""
        got = np.asarray(convolve_separable(jnp.asarray(rgb_image), SHARPEN))
        plan = make_custom_plan(rgb_image.shape[:2], SHARPEN)
        planar = np.moveaxis(rgb_image, -1, 0).astype(np.float64)
        want = np.clip(
            np.floor(oracle.blur_direct(planar, plan) + 0.5), 0, 255
        ).astype(np.uint8)
        d = np.abs(got.astype(int) - np.moveaxis(want, 0, -1).astype(int))
        assert d.max() <= 1

    def test_fft2_symmetric_matches_fused(self, rng):
        x = (rng.random((1, 36, 44)) * 255).astype(np.float32)
        a = np.asarray(convolve_separable(jnp.asarray(x), TENT, engine="fft2"))
        b = np.asarray(convolve_separable(jnp.asarray(x), TENT, engine="fused"))
        np.testing.assert_allclose(a, b, atol=3e-2)

    @pytest.mark.parametrize(
        "engine", ["fft2", "fft_tiles", "fft_mxu", "fft_stream"]
    )
    def test_fft_engines_handle_asymmetric(self, engine, rng):
        """Every FFT engine runs asymmetric taps via the complex spectrum."""
        x = (rng.random((1, 28, 36)) * 255).astype(np.float32)
        got = np.asarray(
            convolve_separable(jnp.asarray(x), DERIV, engine=engine)
        )
        plan = make_custom_plan((28, 36), DERIV)
        want = oracle.blur_direct(x, plan)
        np.testing.assert_allclose(got, want, atol=1e-3)

    def test_fft_engine_fully_asymmetric_taps(self, rng):
        """Non-antisymmetric, non-symmetric taps (general complex spectrum)."""
        taps = np.array([0.1, -0.3, 0.8, 0.25, 0.05], np.float32)
        x = (rng.random((1, 30, 26)) * 255).astype(np.float32)
        for engine in ("fft2", "fft_tiles", "fft_mxu"):
            got = np.asarray(
                convolve_separable(jnp.asarray(x), taps, engine=engine)
            )
            plan = make_custom_plan((30, 26), taps)
            want = oracle.blur_direct(x, plan)
            np.testing.assert_allclose(got, want, atol=2e-3, err_msg=engine)

    def test_auto_asymmetric_routes_off_fft(self, rng):
        """AUTO with asymmetric taps still matches the oracle."""
        x = (rng.random((1, 24, 24)) * 255).astype(np.float32)
        got = np.asarray(convolve_separable(jnp.asarray(x), DERIV, DERIV))
        plan = make_custom_plan((24, 24), DERIV, DERIV)
        want = oracle.blur_direct(x, plan)
        np.testing.assert_allclose(got, want, atol=2e-2)

    def test_auto_wide_asymmetric_no_longer_refused(self, rng):
        """Wide asymmetric taps AUTO-route to an FFT engine and match the
        oracle (round 1 raised here: STATUS.md top known limitation)."""
        width = 5201  # radius 2600 > _AUTO_FUSED_MAX_RADIUS_F32
        t = rng.standard_normal(width).astype(np.float32)
        t[width // 2] += 3.0  # clearly asymmetric
        t /= np.abs(t).sum()
        h, w = 24, 6000
        x = (rng.random((1, h, w)) * 255).astype(np.float32)
        got = np.asarray(
            convolve_separable(jnp.asarray(x), t, np.ones(1, np.float32))
        )
        plan = make_custom_plan((h, w), t, np.ones(1, np.float32))
        assert plan.row.support_radius == 2600
        want = oracle.blur_direct(x, plan)
        np.testing.assert_allclose(got, want, atol=1e-3)

    def test_difference_of_gaussians(self, rng):
        """DoG band-pass: g(1) - g(2), symmetric signed taps, sum ~0."""
        from blur_algorithms.ops.kernels import gaussian_kernel

        g1 = np.pad(gaussian_kernel(1.0, 7), 2)  # width 11
        g2 = gaussian_kernel(2.0, 11)
        dog = (g1 - g2).astype(np.float32)
        x = (rng.random((30, 34)) * 255).astype(np.float32)
        got = np.asarray(convolve_separable(jnp.asarray(x), dog))
        plan = make_custom_plan((30, 34), dog)
        want = oracle.blur_direct(x, plan)
        np.testing.assert_allclose(got, want, atol=3e-2)

    def test_u8_requires_interleaved(self):
        with pytest.raises(ValueError, match="interleaved"):
            convolve_separable(jnp.zeros((16, 16), jnp.uint8), TENT)


class TestReviewRegressions:
    def test_conv_engine_correlation_convention(self, rng):
        """engine='conv' must correlate like every other engine (it used to
        flip taps into convolution, mirroring asymmetric filters)."""
        x = (rng.random((1, 32, 40)) * 255).astype(np.float32)
        ident = np.array([1.0], np.float32)
        a = np.asarray(
            convolve_separable(jnp.asarray(x), DERIV, ident, engine="conv")
        )
        b = np.asarray(
            convolve_separable(jnp.asarray(x), DERIV, ident, engine="fused")
        )
        np.testing.assert_allclose(a, b, atol=2e-2)

    def test_grad_through_asymmetric_taps(self, rng):
        """The fused engine's explicit adjoint must flip asymmetric taps
        (it used to return the negated gradient for DERIV)."""
        import jax

        x = (rng.random((1, 12, 16)) * 10).astype(np.float32)
        ct = rng.random((1, 12, 16)).astype(np.float32)
        ident = np.array([1.0], np.float32)

        def loss(v):
            return jnp.sum(
                jnp.asarray(ct)
                * convolve_separable(v, DERIV, ident, engine="fused")
            )

        g = np.asarray(jax.grad(loss)(jnp.asarray(x)))
        eps = 1e-2
        i = (0, 5, 7)
        xp, xm = x.copy(), x.copy()
        xp[i] += eps
        xm[i] -= eps
        num = (loss(jnp.asarray(xp)) - loss(jnp.asarray(xm))) / (2 * eps)
        assert abs(g[i] - float(num)) < 1e-2, (g[i], float(num))

    def test_width1_taps_must_be_identity(self):
        with pytest.raises(ValueError, match="width 1"):
            make_custom_plan((16, 16), np.array([0.5], np.float32))
        # wide taps centrally truncated to width 1 on a dim-1 axis likewise
        with pytest.raises(ValueError, match="width 1"):
            make_custom_plan(
                (1, 64), np.ones(3, np.float32) / 3, np.ones(5, np.float32) / 5
            )
        # exact identity is fine
        make_custom_plan((16, 16), np.array([1.0], np.float32), TENT)

