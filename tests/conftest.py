"""Test env: CPU backend with 8 virtual devices (sharding tests run here).

The platform is set before JAX initializes a backend. ``-m gpu`` selects
the checks that need an NVIDIA GPU (``tests/test_gpu.py``); those keep the
default backend so that, on a machine with a card, they run on it.
"""

import os

import jax
import numpy as np
import pytest


def pytest_configure(config):
    if config.option.markexpr.strip() == "gpu":
        return
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()
    jax.config.update("jax_platforms", "cpu")


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def rgb_image(rng):
    """Deterministic 96x80 uint8 RGB test image with structure."""
    h, w = 96, 80
    yy, xx = np.mgrid[0:h, 0:w]
    base = (
        127
        + 80 * np.sin(xx / 7.0)
        + 60 * np.cos(yy / 11.0)
        + rng.normal(0, 20, (h, w))
    )
    img = np.stack(
        [base, np.roll(base, 13, axis=0), np.roll(base, 7, axis=1)], axis=-1
    )
    return np.clip(img, 0, 255).astype(np.uint8)
