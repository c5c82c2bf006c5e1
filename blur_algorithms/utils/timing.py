"""Timing/benchmark harness — the observability layer.

The reference's entire tracing stack is ``std::chrono`` spans printed per
engine (``Source.cpp:145,267,282,390,431,568``). Here: a proper device-side
timer (``block_until_ready`` fencing, warmup for compile), wall-ms +
megapixels/s reporting, and an optional ``jax.profiler`` trace dump.
"""

from __future__ import annotations

import contextlib
import dataclasses
import statistics
import time
from typing import Any, Callable

import jax

__all__ = ["BenchResult", "time_fn", "trace"]


@dataclasses.dataclass(frozen=True)
class BenchResult:
    name: str
    mean_ms: float
    median_ms: float
    min_ms: float
    iters: int
    megapixels: float | None = None

    @property
    def mpix_per_s(self) -> float | None:
        if self.megapixels is None:
            return None
        return self.megapixels / (self.median_ms / 1e3)

    def __str__(self) -> str:
        s = (
            f"{self.name}: median {self.median_ms:.3f} ms, "
            f"min {self.min_ms:.3f} ms over {self.iters} iters"
        )
        if self.megapixels is not None:
            s += f" ({self.mpix_per_s:.1f} MP/s)"
        return s


def _block(x: Any) -> None:
    jax.block_until_ready(x)


def time_fn(
    fn: Callable[..., Any],
    *args: Any,
    iters: int = 10,
    warmup: int = 2,
    name: str = "fn",
    megapixels: float | None = None,
) -> BenchResult:
    """Time ``fn(*args)`` with device fencing; warmup covers compilation."""
    for _ in range(max(warmup, 1)):
        _block(fn(*args))
    samples = []
    for _ in range(iters):
        t0 = time.perf_counter()
        _block(fn(*args))
        samples.append((time.perf_counter() - t0) * 1e3)
    return BenchResult(
        name=name,
        mean_ms=statistics.fmean(samples),
        median_ms=statistics.median(samples),
        min_ms=min(samples),
        iters=iters,
        megapixels=megapixels,
    )


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a ``jax.profiler`` trace around the with-block."""
    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()
