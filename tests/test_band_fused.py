"""Banded-matmul engine internals: the XLA band route and the fused
engine's route choice."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from blur_algorithms import oracle
from blur_algorithms.ops.band_matmul import (
    band_block_matrix,
    blur_band_matmul,
    pick_block,
)
from blur_algorithms.ops.kernels import box_passes_kernel, gaussian_kernel
from blur_algorithms.ops.plan import make_plan


class TestBandMatrix:
    def test_structure(self):
        taps = np.array([1.0, 2.0, 3.0, 2.0, 1.0], dtype=np.float32)
        mat = band_block_matrix(taps, 4)  # (4 + 4) x 4
        assert mat.shape == (8, 4)
        for j in range(4):
            np.testing.assert_array_equal(mat[j : j + 5, j], taps)
        # off-band is zero
        assert mat[6, 0] == 0 and mat[0, 2] == 0

    def test_window_matmul_is_valid_conv(self, rng):
        taps = gaussian_kernel(2.0, 9)
        mat = band_block_matrix(taps, 16)
        window = rng.random(16 + 8).astype(np.float32)
        got = window @ mat
        want = np.convolve(window.astype(np.float64), taps[::-1], mode="valid")
        np.testing.assert_allclose(got, want, atol=1e-4)

    def test_pick_block(self):
        assert pick_block(4096, 32) % 128 == 0
        assert pick_block(4096, 32) >= 4 * 32
        assert pick_block(100, 8) == 128  # clamped to lane-aligned axis


class TestBandEngine:
    def test_matches_direct_oracle(self, rng):
        x = rng.random((3, 41, 57)).astype(np.float32) * 255
        plan = make_plan((41, 57), 6.0)
        got = np.asarray(blur_band_matmul(jnp.asarray(x), plan))
        want = oracle.blur_direct(x, plan)
        np.testing.assert_allclose(got, want, atol=5e-3)

    def test_explicit_block_sizes_agree(self, rng):
        x = rng.random((2, 64, 200)).astype(np.float32) * 255
        plan = make_plan((64, 200), 4.0)
        a = np.asarray(blur_band_matmul(jnp.asarray(x), plan, block=128))
        b = np.asarray(blur_band_matmul(jnp.asarray(x), plan, block=256))
        np.testing.assert_allclose(a, b, atol=1e-3)


class TestBoxFold:
    def test_effective_taps_match_sequential_convolution(self):
        for r, p in [(1, 1), (3, 2), (4, 3)]:
            taps = box_passes_kernel(r, p)
            assert taps.shape == (p * 2 * r + 1,)
            box = np.ones(2 * r + 1) / (2 * r + 1)
            want = box
            for _ in range(p - 1):
                want = np.convolve(want, box)
            np.testing.assert_allclose(taps, want, atol=1e-7)
            assert abs(taps.sum() - 1.0) < 1e-6

    def test_fold_equals_sequential_passes(self, rng):
        """One effective-taps pass == 2 sequential reflect-101 box passes."""
        from blur_algorithms.ops.box_blur import box_blur_planar

        x = rng.random((30, 44)).astype(np.float32) * 255
        seq = np.asarray(box_blur_planar(jnp.asarray(x), 3, passes=2))
        plan = make_plan((30, 44), 3, kernel="box_fast", box_passes=2)
        fold = np.asarray(blur_band_matmul(jnp.asarray(x), plan))
        np.testing.assert_allclose(fold, seq, atol=2e-2)

    def test_box_fast_plan_radius_zero(self):
        plan = make_plan((16, 16), 0, kernel="box_fast")
        assert plan.row.support_radius == 0
        x = jnp.arange(256, dtype=jnp.float32).reshape(16, 16)
        np.testing.assert_allclose(np.asarray(blur_band_matmul(x, plan)), x)


class TestBandBf16x3:
    """The XLA band route in bf16x3: bf16 hi/lo products with float32
    accumulation, within float rounding of the float64 direct oracle."""

    @pytest.mark.parametrize(
        "shape,sigma",
        [
            ((41, 57), 1.0),
            ((41, 57), 6.0),
            ((64, 200), 4.0),
            ((33, 17), (5.0, 1.5)),
            ((128, 96), 20.0),
            ((7, 300), 8.0),
        ],
    )
    def test_float_matches_direct_oracle(self, rng, shape, sigma):
        x = rng.random((2,) + shape).astype(np.float32) * 255
        plan = make_plan(shape, sigma)
        got = np.asarray(blur_band_matmul(jnp.asarray(x), plan, "bf16x3"))
        want = oracle.blur_direct(x, plan)
        np.testing.assert_allclose(got, want, atol=2e-2)

    @pytest.mark.parametrize("sigma", [0.8, 3.0, 10.0])
    @pytest.mark.parametrize("shape", [(48, 64), (37, 91)])
    def test_u8_within_one_count(self, rng, shape, sigma):
        from blur_algorithms.ops.layout import round_to_u8

        img = (rng.random((3,) + shape) * 255).astype(np.uint8)
        plan = make_plan(shape, sigma)
        got = np.asarray(round_to_u8(
            blur_band_matmul(jnp.asarray(img, jnp.float32), plan, "bf16x3")))
        want = np.clip(np.floor(oracle.blur_direct(img, plan) + 0.5), 0, 255)
        d = np.abs(got.astype(int) - want.astype(int))
        assert d.max() <= 1 and (d == 0).mean() > 0.99

    def test_signed_taps(self, rng):
        from blur_algorithms.ops.plan import make_custom_plan

        taps = np.array([-0.25, 1.5, -0.25], np.float32)
        plan = make_custom_plan((40, 48), taps)
        x = rng.random((40, 48)).astype(np.float32) * 255
        got = np.asarray(blur_band_matmul(jnp.asarray(x), plan, "bf16x3"))
        np.testing.assert_allclose(got, oracle.blur_direct(x, plan), atol=2e-2)


class TestFusedRoute:
    """ops/fused.py decides kernel vs XLA band route by platform."""

    def test_cpu_takes_the_xla_band_route(self):
        from blur_algorithms.ops import fused

        assert jax.default_backend() == "cpu"
        assert fused.kernel_tiling(make_plan((64, 64), 3.0), 1) is None

    @pytest.mark.parametrize("in_bytes", [1, 4])
    def test_gpu_takes_the_kernel_within_reach(self, monkeypatch, in_bytes):
        from blur_algorithms.ops import fused

        monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
        t = fused.kernel_tiling(make_plan((2160, 3840), 10.0), in_bytes)
        assert t is not None and t.ww >= t.tw + 2 * 32

    def test_gpu_past_reach_takes_the_xla_band_route(self, monkeypatch):
        from blur_algorithms.ops import fused
        from blur_algorithms.pallas_kernels.fused_band import MAX_RADIUS

        monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
        plan = make_plan((2160, 3840), 60.0)
        assert plan.row.support_radius > MAX_RADIUS
        assert fused.kernel_tiling(plan, 1) is None

    @pytest.mark.parametrize("entry", ["blur_fused", "blur_fused_u8"])
    def test_gpu_dispatches_to_the_kernel(self, monkeypatch, entry):
        from blur_algorithms.ops import fused
        from blur_algorithms.pallas_kernels import fused_band

        calls = []
        monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
        for name in ("fused_band_call", "blur_fused_band_u8", "blur_fused_band"):
            monkeypatch.setattr(
                fused_band, name,
                lambda x, *a, name=name, **k: (calls.append(name), x)[1],
            )
        x = jnp.zeros((3, 32, 48), jnp.uint8)
        getattr(fused, entry)(x, make_plan((32, 48), 2.0))
        assert calls

    def test_cpu_never_calls_the_kernel(self, monkeypatch, rng):
        from blur_algorithms.ops import fused
        from blur_algorithms.pallas_kernels import fused_band

        monkeypatch.setattr(
            fused_band, "fused_band_call",
            lambda *a, **k: pytest.fail("kernel called on CPU"),
        )
        img = (rng.random((3, 32, 48)) * 255).astype(np.uint8)
        plan = make_plan((32, 48), 2.0)
        got = np.asarray(fused.blur_fused_u8(jnp.asarray(img), plan))
        want = np.clip(np.floor(oracle.blur_direct(img, plan) + 0.5), 0, 255)
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1

    def test_haloed_xla_route_matches_whole_frame(self, rng):
        """The haloed step over exact halo rows equals the whole-frame blur."""
        from blur_algorithms.ops import fused
        from blur_algorithms.ops.pad import reflect_101

        x = rng.random((2, 40, 56)).astype(np.float32) * 255
        plan = make_plan((40, 56), 3.0)
        rh = plan.col.support_radius
        haloed = reflect_101(jnp.asarray(x), [(rh, rh)], axes=[-2])
        got = np.asarray(fused.blur_fused_haloed(haloed, plan))
        np.testing.assert_allclose(got, oracle.blur_direct(x, plan), atol=1e-2)
