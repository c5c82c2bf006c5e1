"""Native host runtime (libblurfx.so) parity with the NumPy oracle."""

import numpy as np
import pytest

from blur_algorithms import oracle
from blur_algorithms.utils import native

@pytest.fixture(scope="module")
def built():
    """The native library, built from native/blurfx.cpp when missing."""
    if not native.available() and not native.build():
        pytest.skip("libblurfx.so could not be built (make -C native)")


needs_native = pytest.mark.usefixtures("built")


@needs_native
def test_deinterleave_matches_numpy(rng):
    img = (rng.random((37, 53, 3)) * 255).astype(np.uint8)
    got = native.deinterleave(img)
    np.testing.assert_array_equal(got, np.moveaxis(img, -1, 0).astype(np.float32))


@needs_native
def test_interleave_rounding(rng):
    planar = (rng.random((3, 20, 30)) * 255).astype(np.float32)
    got = native.interleave(planar)
    want = np.clip(np.floor(np.moveaxis(planar, 0, -1) + 0.5), 0, 255).astype(np.uint8)
    np.testing.assert_array_equal(got, want)


@needs_native
def test_interleave_saturates():
    planar = np.array([[[-5.0]], [[260.0]], [[254.5]]], dtype=np.float32)
    got = native.interleave(planar)
    np.testing.assert_array_equal(got.ravel(), [0, 255, 255])


@needs_native
def test_reflect101_matches_oracle(rng):
    img = (rng.random((12, 9, 3)) * 255).astype(np.uint8)
    for pads in [((4, 5), (3, 6)), ((0, 0), (2, 2)), ((11, 11), (8, 8)), ((15, 2), (1, 12))]:
        got = native.reflect101_u8(img, pads)
        want = oracle.reflect_101_np(img, list(pads), axes=[0, 1])
        np.testing.assert_array_equal(got, want)


@needs_native
def test_crc32_vector_and_chaining():
    data = np.frombuffer(b"123456789", dtype=np.uint8)
    assert native.crc32(data) == 0xCBF43926
    assert native.crc32(data[:3], data[3:]) == 0xCBF43926
    assert native.crc32(data) == oracle.crc32c(data)


def test_fallbacks_work_without_library(monkeypatch, rng):
    monkeypatch.setattr(native, "_load", lambda: None)
    img = (rng.random((10, 11, 3)) * 255).astype(np.uint8)
    pl = native.deinterleave(img)
    np.testing.assert_array_equal(pl, np.moveaxis(img, -1, 0).astype(np.float32))
    assert native.crc32(np.frombuffer(b"123456789", np.uint8)) == 0xCBF43926
    padded = native.reflect101_u8(img, ((2, 2), (3, 3)))
    assert padded.shape == (14, 17, 3)
