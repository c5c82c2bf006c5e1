"""Checks that need an NVIDIA GPU: the same check functions chip_smoke.py
runs, at smaller sizes. Run them on the card with

    python -m pytest -m gpu tests/test_gpu.py
"""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

pytestmark = pytest.mark.gpu


@pytest.fixture
def cs():
    import jax

    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (run with -m gpu on the card)")
    import chip_smoke

    return chip_smoke


def test_headline(cs):
    assert cs.check_headline(2, 540, 960, 10.0)["max_err"] <= 1


def test_kernel_vs_xla(cs):
    res = cs.check_kernel_vs_xla(2, 540, 960, 10.0)
    assert res["kernel"]["max_err"] <= 1


def test_wide_radius(cs):
    cs.check_wide(540, 960, (40.0, 150.0))


def test_giant_frame_patches(cs):
    cs.check_giant(2048, 3072, 30.0, patch=256)


def test_box(cs):
    cs.check_box(540, 960, (3.0, 8.0), patch=256)


def test_served(cs):
    cs.check_served(((270, 480),), (3.0, 10.0), warm=1)


def test_grad(cs):
    cs.check_grad(256, 256, 6.0)
