"""Coverage for utils (io edge cases, timing harness) and api edge engines."""

import os

import numpy as np
import pytest

import jax.numpy as jnp

from blur_algorithms import Engine, blur_u8
from blur_algorithms.utils import io
from blur_algorithms.utils.timing import BenchResult, time_fn


class TestIO:
    def test_grayscale_png_round_trip(self, tmp_path, rng):
        img = (rng.random((20, 30)) * 255).astype(np.uint8)
        path = str(tmp_path / "g.png")
        io.write_image(path, img)
        back = io.read_image(path)  # PIL converts to RGB
        assert back.shape == (20, 30, 3)
        np.testing.assert_array_equal(back[..., 0], img)

    def test_ppm_with_comments(self, tmp_path):
        path = tmp_path / "c.ppm"
        path.write_bytes(b"P6\n# a comment\n2 2\n255\n" + bytes(range(12)))
        img = io.read_image(str(path))
        assert img.shape == (2, 2, 3)
        assert img[0, 0, 0] == 0 and img[1, 1, 2] == 11

    def test_bad_ppm_magic(self, tmp_path):
        path = tmp_path / "bad.ppm"
        path.write_bytes(b"P3\n2 2\n255\n")
        with pytest.raises(ValueError, match="magic"):
            io.read_image(str(path))

    def test_npy_requires_uint8(self, tmp_path):
        path = tmp_path / "f.npy"
        np.save(str(path), np.zeros((4, 4, 3), np.float32))
        with pytest.raises(ValueError, match="uint8"):
            io.read_image(str(path))


class TestTiming:
    def test_time_fn_reports(self):
        r = time_fn(lambda x: x + 1, jnp.zeros(16), iters=3, warmup=1,
                    name="t", megapixels=1.0)
        assert isinstance(r, BenchResult)
        assert r.min_ms <= r.median_ms
        assert r.mpix_per_s and r.mpix_per_s > 0
        assert "t:" in str(r)


class TestEdgeEngines:
    def test_fft_stream_u8_api_small(self, rng):
        img = (rng.random((40, 50, 3)) * 255).astype(np.uint8)
        got = np.asarray(blur_u8(jnp.asarray(img), 3.0, engine=Engine.FFT_STREAM))
        want = np.asarray(blur_u8(jnp.asarray(img), 3.0, engine=Engine.FFT_TILES))
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1

    def test_cascade_u8_api_small_sigma_single_step(self, rng):
        img = (rng.random((40, 50, 3)) * 255).astype(np.uint8)
        got = np.asarray(blur_u8(jnp.asarray(img), 2.0, engine=Engine.CASCADE))
        want = np.asarray(blur_u8(jnp.asarray(img), 2.0, engine=Engine.FUSED))
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


class TestPersistentCache:
    """utils/cache.py: cross-process XLA compile cache (CLI analog of the
    reference's in-process pocketfft plan cache, Source.cpp:4-5)."""

    def _reset(self):
        import jax

        jax.config.update("jax_compilation_cache_dir", None)
        # the cache binds to the first dir used in the process
        # (jax._src.compilation_cache: "initialization is done at most
        # once"); drop it so each test really targets its own directory
        from jax._src import compilation_cache as _cc

        _cc.reset_cache()

    def test_default_dir_is_fixed_inside_the_checkout(self):
        from blur_algorithms.utils import cache

        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        assert cache.DEFAULT_DIR == os.path.join(root, ".jax_cache")
        with open(os.path.join(root, ".gitignore")) as f:
            assert ".jax_cache/" in f.read().split()

    def test_default_dir_used_when_env_unset(self, monkeypatch):
        import jax

        from blur_algorithms.utils import cache

        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        try:
            assert cache.enable_persistent_cache() == cache.DEFAULT_DIR
            assert os.path.isdir(cache.DEFAULT_DIR)
            assert jax.config.jax_compilation_cache_dir == cache.DEFAULT_DIR
        finally:
            self._reset()

    def test_env_dir_honoured_and_no_other_set(self, tmp_path, monkeypatch):
        import jax

        from blur_algorithms.utils.cache import enable_persistent_cache

        d = str(tmp_path / "via_env")
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", d)
        self._reset()
        try:
            assert enable_persistent_cache() == d
            # the directory is JAX's own reading of the variable
            assert jax.config.jax_compilation_cache_dir in (None, d)
        finally:
            self._reset()

    def test_compiled_program_persisted(self, tmp_path, monkeypatch):
        """A jitted program lands in the cache dir (min thresholds zeroed)."""
        import jax

        from blur_algorithms.utils.cache import enable_persistent_cache

        d = str(tmp_path / "xla_cache")
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        self._reset()  # detach from any dir an earlier test bound
        try:
            assert enable_persistent_cache(min_compile_secs=0.0)
            jax.config.update("jax_compilation_cache_dir", d)

            @jax.jit
            def f(x):
                return (x * 2.0 + 1.0).sum()

            f(jnp.arange(64.0).reshape(8, 8)).block_until_ready()
            assert os.listdir(d), "no cache entry written"
        finally:
            self._reset()
