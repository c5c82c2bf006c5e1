"""Per-device numbers for routing, tiling and roofline shares.

A small table keyed by ``jax.devices()[0].device_kind``. The H100 entry's
published figures come from NVIDIA's H100 SXM data sheet (dense rates,
without sparsity, at the 700 W power limit); its routing crossovers were
measured on that card (``PERF.md``, "Crossover probe"). The CPU entry
exists so the test suite routes like the card does; it has no peaks. A
kind that is not in the table is an error: routing decisions taken from
another device's model would be wrong without a sign.
"""

from __future__ import annotations

import dataclasses
import functools

__all__ = ["DeviceSpec", "H100", "CPU", "budgets", "device_kind", "spec_for_kind"]

_GB = 10**9


@dataclasses.dataclass(frozen=True)
class DeviceSpec:
    kind: str
    hbm_bytes: int
    hbm_gbps: float | None  # GB/s
    peak_bf16_tflops: float | None
    peak_int8_tops: float | None
    peak_tf32_tflops: float | None
    peak_fp32_tflops: float | None
    smem_block_bytes: int  # shared memory one block may use
    # largest support radius AUTO serves with the band routes (kernel or
    # XLA) before the FFT route takes over, per input width
    auto_fused_max_radius_u8: int
    auto_fused_max_radius_f32: int
    # box blur: past this radius the O(1)/px cumsum scan beats the taps
    box_scan_crossover_radius: int
    # AUTO row-shards a single frame over several devices from this size on
    auto_sp_min_px: int

    @property
    def fft_mxu_byte_budget(self) -> int:
        """Whole-frame FFT intermediates beyond this stream in strips."""
        return self.hbm_bytes * 10 // 16

    @property
    def split_hbm_budget(self) -> int:
        """Per-shard halo context beyond half of this reroutes to the FFT."""
        return self.hbm_bytes * 11 // 16


H100 = DeviceSpec(
    kind="NVIDIA H100 80GB HBM3",
    hbm_bytes=80 * _GB,
    hbm_gbps=3350.0,
    peak_bf16_tflops=989.0,
    peak_int8_tops=1979.0,
    peak_tf32_tflops=495.0,
    peak_fp32_tflops=67.0,
    smem_block_bytes=227 * 1024,
    auto_fused_max_radius_u8=112,
    auto_fused_max_radius_f32=112,
    box_scan_crossover_radius=112,
    auto_sp_min_px=1 << 26,
)

# the same routing and budgets as the H100, without peaks
CPU = dataclasses.replace(
    H100,
    kind="cpu",
    hbm_gbps=None,
    peak_bf16_tflops=None,
    peak_int8_tops=None,
    peak_tf32_tflops=None,
    peak_fp32_tflops=None,
)

_TABLE = {spec.kind: spec for spec in (H100, CPU)}


def device_kind() -> str:
    """``device_kind`` of the default backend's first device."""
    import jax

    return jax.devices()[0].device_kind


def spec_for_kind(kind: str) -> DeviceSpec:
    """The table entry for ``kind``; an unknown kind raises ``KeyError``."""
    try:
        return _TABLE[kind]
    except KeyError:
        raise KeyError(
            f"no device spec for kind {kind!r}; known kinds: {sorted(_TABLE)}"
        ) from None


@functools.lru_cache(maxsize=8)
def _budgets_for(kind: str) -> DeviceSpec:
    return spec_for_kind(kind)


def budgets(kind: str | None = None) -> DeviceSpec:
    """The spec of ``kind`` (default: the current backend's device),
    cached per kind."""
    return _budgets_for(device_kind() if kind is None else kind)
