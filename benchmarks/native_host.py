"""Host staging benchmark: native/blurfx.cpp vs the NumPy fallback.

The streaming pipeline (``BlurPipeline.stream``) does its bucket reflect-101
pad on the host inside the stager threads — the exact role the reference's
``Utils.hpp`` ``Reflect_101``/interleave plays on its CPU — so the device
program compiles without a pad op and the pad cost hides behind the previous
frame's device blur. This measures that host step both ways.

Run: python benchmarks/native_host.py  -> prints JSON, writes
benchmarks/native_host.json
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from blur_algorithms.oracle import crc32c, reflect_101_np
from blur_algorithms.utils import native


def _time(fn, reps: int = 7) -> float:
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best * 1e3  # ms


def main() -> dict:
    rng = np.random.default_rng(0)
    h, w = 2160, 3840  # 4K frame
    img = (rng.random((h, w, 3)) * 255).astype(np.uint8)
    pads = ((0, 96), (0, 128))  # a typical bucket pad

    rows = {}
    native_ok = native.available()
    rows["native_available"] = native_ok

    want = reflect_101_np(img, list(pads), axes=[0, 1])
    if native_ok:
        got = native.reflect101_u8(img, pads)
        assert np.array_equal(got, want), "native reflect mismatch"
        rows["reflect101_native_ms"] = round(
            _time(lambda: native.reflect101_u8(img, pads)), 3
        )
    rows["reflect101_numpy_ms"] = round(
        _time(lambda: reflect_101_np(img, list(pads), axes=[0, 1])), 3
    )

    if native_ok:
        rows["deinterleave_native_ms"] = round(
            _time(lambda: native.deinterleave(img)), 3
        )
    rows["deinterleave_numpy_ms"] = round(
        _time(lambda: np.moveaxis(img, -1, 0).astype(np.float32)), 3
    )

    planar = np.moveaxis(img, -1, 0).astype(np.float32) + 0.4
    if native_ok:
        rows["interleave_native_ms"] = round(
            _time(lambda: native.interleave(planar)), 3
        )
    rows["interleave_numpy_ms"] = round(
        _time(
            lambda: np.clip(
                np.floor(np.moveaxis(planar, 0, -1) + 0.5), 0, 255
            ).astype(np.uint8)
        ),
        3,
    )

    flat = img.reshape(-1)
    if native_ok:
        rows["crc32_native_ms"] = round(_time(lambda: native.crc32(flat)), 3)
        assert native.crc32(flat) == crc32c(flat)
    rows["crc32_numpy_ms"] = round(_time(lambda: crc32c(flat)), 3)

    out = os.path.join(os.path.dirname(__file__), "native_host.json")
    with open(out, "w") as f:
        json.dump(rows, f, indent=1)
    print(json.dumps(rows))
    return rows


if __name__ == "__main__":
    main()
