"""Persistent XLA compilation cache for cross-process reuse.

The reference keeps an in-process FFT plan cache (``POCKETFFT_CACHE_SIZE``,
``Source.cpp:4-5``) so repeated transforms of one size are planned once.
The XLA analog is heavier: every distinct (shape, sigma, engine) tuple is a
compiled program, and a CLI invocation is a fresh process — without a disk
cache each run pays the full compile. JAX's persistent compilation cache
writes serialized executables keyed by the program fingerprint, so repeat
runs load them instead.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and this
module sets no other directory; otherwise the cache lives at a fixed path
inside the checkout (``.jax_cache/``, ignored by git).
"""

from __future__ import annotations

import os

__all__ = ["DEFAULT_DIR", "enable_persistent_cache"]

DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_persistent_cache(min_compile_secs: float = 1.0) -> str:
    """Turn on JAX's persistent compilation cache; returns its directory.

    Programs compiling faster than ``min_compile_secs`` are not persisted
    — they recompile faster than a disk round trip. Call this before the
    first compile: JAX binds its cache to the first directory it uses.
    """
    import jax

    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", min_compile_secs)
    env_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env_dir:
        return env_dir
    os.makedirs(DEFAULT_DIR, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
