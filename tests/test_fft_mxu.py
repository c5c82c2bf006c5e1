"""Four-step matmul-DFT convolution engine (``fft_mxu``, XLA einsums)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from blur_algorithms import Engine, oracle
from blur_algorithms.api import _resolve_engine
from blur_algorithms.ops.fft_mxu import (
    _factor,
    blur_fft_mxu,
    estimate_bytes,
)
from blur_algorithms.ops.plan import make_plan


def test_factor_contract():
    # small pow2: balanced near-sqrt stages
    assert _factor(256) == (16, 16)
    assert _factor(1024) == (32, 32)
    # composite lengths (128 * m): stage 1 locked to 128-wide tiles
    assert _factor(8192) == (128, 64)
    assert _factor(16384) == (128, 128)
    assert _factor(5120) == (128, 40)
    assert _factor(32768) == (128, 256)
    for n in (256, 1024, 4096, 5120, 12288, 32768):
        n1, n2 = _factor(n)
        assert n1 * n2 == n


def test_transform_length_composite():
    from blur_algorithms.ops.fft_mxu import transform_length

    plan = make_plan((2160, 3840), 160.0)  # rows need 3840 + 2*531 = 4902
    n = transform_length(plan.row)
    assert n == 5120  # not the pow2 8192: pad waste bounded at ~3%
    assert n >= plan.row.dim + 2 * plan.row.pad
    small = make_plan((96, 160), 3.0)
    assert transform_length(small.row) == 256  # pow2 floor for short axes


@pytest.mark.parametrize("sigma", [3.0, 30.0, 60.0])
def test_einsum_form_matches_oracle(rng, sigma):
    x = rng.random((2, 96, 160)).astype(np.float32) * 255
    plan = make_plan((96, 160), sigma)
    want = oracle.blur_direct(x, plan)
    for prec in (jax.lax.Precision.HIGHEST, "bf16x3"):
        got = np.asarray(blur_fft_mxu(jnp.asarray(x), plan, precision=prec))
        assert np.abs(got - want).max() < 0.02


def test_auto_routes_giant_radius_to_fft_mxu():
    """Past the band/FFT crossover AUTO takes the FFT: ``fft_tiles``
    (measured faster than this engine's matmul DFT at radius 1024 and 2048
    on an H100), strip-streamed once the whole-frame transform
    intermediates outgrow the device budget. ``fft_mxu`` stays an explicit
    engine."""
    from blur_algorithms.ops.streamed import estimate_fft_tiles_bytes
    from blur_algorithms.utils.hw import budgets

    r_max = budgets().auto_fused_max_radius_u8
    mid = make_plan((8192, 8192), 900.0)
    assert mid.row.support_radius > r_max
    assert _resolve_engine(Engine.AUTO, mid) is Engine.FFT_TILES
    below = make_plan((8192, 8192), 20.0)
    assert below.row.support_radius <= r_max
    assert _resolve_engine(Engine.AUTO, below) is Engine.FUSED
    giant = make_plan((14500, 24000), 155.0)
    assert _resolve_engine(Engine.AUTO, giant) is Engine.FFT_TILES
    # a batch of 24 giant planes outgrows the budget: strips
    assert estimate_fft_tiles_bytes(giant, 24) > budgets().fft_mxu_byte_budget
    assert _resolve_engine(Engine.AUTO, giant, lead=24) is Engine.FFT_STREAM


def test_fft_mxu_streams_frames_past_the_budget(rng, monkeypatch):
    """An explicit fft_mxu request on a frame whose padded rows outgrow the
    byte budget runs the strip-streamed tiles path (same result)."""
    import dataclasses

    from blur_algorithms import api
    from blur_algorithms.ops.fft_conv import blur_fft_tiles
    from blur_algorithms.utils import hw

    tiny = dataclasses.replace(hw.CPU, hbm_bytes=1024)
    monkeypatch.setattr(hw, "budgets", lambda: tiny)
    x = jnp.asarray(rng.random((2, 40, 56)).astype(np.float32) * 255)
    plan = make_plan((40, 56), 4.0)
    got = np.asarray(api._blur_planar(x, plan, Engine.FFT_MXU))
    want = np.asarray(blur_fft_tiles(x, plan))
    np.testing.assert_allclose(got, want, atol=1e-3)


def test_auto_float_crossover_is_lower():
    """AUTO's float and uint8 crossovers come from the device table: a
    radius at the crossover stays on the band route for both, one past it
    goes to the FFT for both."""
    from blur_algorithms.utils.hw import budgets

    b = budgets()
    for in_bytes, r_max in ((1, b.auto_fused_max_radius_u8),
                            (4, b.auto_fused_max_radius_f32)):
        s = (r_max + 1) / 3.33
        while make_plan((4096, 4096), s).row.support_radius <= r_max:
            s += 0.05
        past = make_plan((4096, 4096), s)
        assert _resolve_engine(Engine.AUTO, past, in_bytes) is Engine.FFT_TILES
        at = make_plan((4096, 4096), 10.0)
        assert _resolve_engine(Engine.AUTO, at, in_bytes) is Engine.FUSED


