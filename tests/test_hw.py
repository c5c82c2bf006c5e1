"""The device table (utils/hw.py) and the fused kernel's tile choice."""

import dataclasses

import pytest

from blur_algorithms.pallas_kernels import fused_band as fb
from blur_algorithms.utils import hw


class TestDeviceTable:
    def test_h100_entry_is_the_data_sheet(self):
        spec = hw.spec_for_kind("NVIDIA H100 80GB HBM3")
        assert spec is hw.H100
        assert spec.hbm_bytes == 80 * 10**9
        assert spec.hbm_gbps == 3350.0
        assert spec.peak_bf16_tflops == 989.0
        assert spec.peak_int8_tops == 1979.0
        assert spec.peak_tf32_tflops == 495.0
        assert spec.peak_fp32_tflops == 67.0
        assert spec.smem_block_bytes == 227 * 1024

    @pytest.mark.parametrize(
        "kind", ["", "NVIDIA H100", "NVIDIA A100-SXM4-80GB", "Host", "gpu"]
    )
    def test_unknown_kind_raises(self, kind):
        with pytest.raises(KeyError, match="no device spec"):
            hw.spec_for_kind(kind)

    def test_cpu_entry_routes_like_the_card(self):
        cpu = hw.spec_for_kind("cpu")
        assert cpu.peak_bf16_tflops is None and cpu.hbm_gbps is None
        for field in ("auto_fused_max_radius_u8", "auto_fused_max_radius_f32",
                      "box_scan_crossover_radius", "auto_sp_min_px",
                      "fft_mxu_byte_budget", "split_hbm_budget"):
            assert getattr(cpu, field) == getattr(hw.H100, field), field

    def test_budgets_derive_from_80_gb(self):
        assert hw.H100.fft_mxu_byte_budget == 80 * 10**9 * 10 // 16
        assert hw.H100.split_hbm_budget == 80 * 10**9 * 11 // 16
        assert 0 < hw.H100.fft_mxu_byte_budget < hw.H100.split_hbm_budget

    def test_crossovers_are_within_the_kernel_reach(self):
        assert hw.H100.auto_fused_max_radius_u8 <= fb.MAX_RADIUS
        assert hw.H100.box_scan_crossover_radius <= fb.MAX_RADIUS

    def test_budgets_keyed_by_kind(self):
        assert hw.budgets("cpu") is hw.CPU
        assert hw.budgets("NVIDIA H100 80GB HBM3") is hw.H100
        assert hw.budgets() is hw.budgets("cpu")  # the test backend
        with pytest.raises(KeyError):
            hw.budgets("NVIDIA H200")

    def test_spec_is_frozen(self):
        with pytest.raises(dataclasses.FrozenInstanceError):
            hw.H100.hbm_bytes = 1


RADII = [0, 1, 2, 5, 9, 16, 31, 32, 47, 48, 49, 64, 95, 96, 97, 111, 112]


def _pow2(n):
    return n > 0 and n & (n - 1) == 0


@pytest.mark.parametrize("in_bytes", [1, 4])
@pytest.mark.parametrize("r", RADII)
def test_tiling_is_pow2_and_fits_shared_memory(r, in_bytes):
    t = fb.pick_tiling(r, r, 2160, 3840, in_bytes)
    assert t is not None
    for edge in (t.th, t.tw, t.kc, t.ww):
        assert _pow2(edge) and edge >= 16
    assert t.ww >= t.tw + 2 * r
    assert t.nk * t.kc >= t.th + 2 * r
    assert fb.smem_bytes(t, in_bytes) <= hw.H100.smem_block_bytes


@pytest.mark.parametrize("rh,rw", [(113, 0), (0, 113), (200, 200), (2000, 10)])
def test_no_tiling_past_the_kernel_reach(rh, rw):
    assert fb.pick_tiling(rh, rw, 2160, 3840, 1) is None


@pytest.mark.parametrize("h,w", [(9, 11), (20, 24), (64, 40), (1, 300)])
def test_tiles_shrink_to_small_frames(h, w):
    t = fb.pick_tiling(3, 3, h, w, 1)
    assert t.th <= max(16, fb._next_pow2(h))
    assert t.tw <= max(16, fb._next_pow2(w))


def test_measured_tilings_at_4k():
    """The table the H100 sweep picked (PERF.md, "Tiling sweep")."""
    def edges(r):
        t = fb.pick_tiling(r, r, 2160, 3840, 1)
        return t.th, t.tw, t.kc, t.warps, t.stages

    assert edges(32) == (128, 32, 64, 4, 2)
    assert edges(64) == (64, 64, 64, 4, 2)
    assert edges(100) == (128, 32, 64, 4, 2)
