"""Reflect-101 padding (Utils.hpp:212-243) and layout ops (Utils.hpp:159-210)."""

import jax.numpy as jnp
import numpy as np

from blur_algorithms.oracle import reflect_101_np
from blur_algorithms.ops.layout import from_planar, to_planar
from blur_algorithms.ops.pad import clamp_pad, reflect_101


class TestReflect101:
    def test_readme_example(self):
        # README.md:47-53: pad 6 of ABCDEFG -> g f e d c b | A..G | f e d c b a
        x = jnp.arange(1, 8, dtype=jnp.float32)  # A..G = 1..7
        out = np.asarray(reflect_101(x, [(6, 6)]))
        np.testing.assert_array_equal(
            out, [7, 6, 5, 4, 3, 2, 1, 2, 3, 4, 5, 6, 7, 6, 5, 4, 3, 2, 1]
        )

    def test_2d_matches_numpy_oracle(self, rng):
        x = rng.random((9, 7)).astype(np.float32)
        out = np.asarray(reflect_101(jnp.asarray(x), [(3, 5), (2, 6)]))
        np.testing.assert_array_equal(out, reflect_101_np(x, [(3, 5), (2, 6)]))

    def test_matches_cv2_copymakeborder(self, rng):
        cv2 = __import__("cv2")
        x = (rng.random((12, 10)) * 255).astype(np.uint8)
        ours = np.asarray(
            reflect_101(jnp.asarray(x, dtype=jnp.float32), [(4, 4), (3, 3)])
        )
        ref = cv2.copyMakeBorder(x, 4, 4, 3, 3, cv2.BORDER_REFLECT_101)
        np.testing.assert_array_equal(ours, ref.astype(np.float32))

    def test_clamp_to_dim_minus_1(self):
        x = jnp.arange(1, 4, dtype=jnp.float32)  # len 3, max reflect pad 2
        out = np.asarray(reflect_101(x, [(4, 4)]))
        # reflect 2, zeros for the remaining 2 on each side
        np.testing.assert_array_equal(out, [0, 0, 3, 2, 1, 2, 3, 2, 1, 0, 0])
        assert clamp_pad(4, 3) == 2
        assert clamp_pad(-1, 3) == 0

    def test_batched_leading_dims(self, rng):
        x = rng.random((2, 3, 8, 6)).astype(np.float32)
        out = np.asarray(reflect_101(jnp.asarray(x), [(2, 2), (1, 1)]))
        assert out.shape == (2, 3, 12, 8)
        for b in range(2):
            for c in range(3):
                np.testing.assert_array_equal(
                    out[b, c], reflect_101_np(x[b, c], [(2, 2), (1, 1)])
                )


class TestLayout:
    def test_round_trip_identity(self, rgb_image):
        planar = to_planar(jnp.asarray(rgb_image))
        assert planar.shape == (3,) + rgb_image.shape[:2]
        assert planar.dtype == jnp.float32
        back = np.asarray(from_planar(planar))
        np.testing.assert_array_equal(back, rgb_image)

    def test_round_half_up(self):
        planar = jnp.asarray([[[0.49]], [[0.5]], [[254.49]]], dtype=jnp.float32)
        out = np.asarray(from_planar(planar))
        np.testing.assert_array_equal(out.ravel(), [0, 1, 254])

    def test_clip_out_of_range(self):
        planar = jnp.asarray([[[-3.0]], [[256.7]], [[255.49]]], dtype=jnp.float32)
        out = np.asarray(from_planar(planar))
        np.testing.assert_array_equal(out.ravel(), [0, 255, 255])

    def test_batched(self, rgb_image):
        batch = jnp.stack([jnp.asarray(rgb_image)] * 4)
        planar = to_planar(batch)
        assert planar.shape == (4, 3) + rgb_image.shape[:2]
        np.testing.assert_array_equal(np.asarray(from_planar(planar))[2], rgb_image)

    def test_integral_targets_round_half_up(self):
        """Every integral target gets the reference's +0.5 round-half-up
        and range clip, not just uint8 (Utils.hpp:189 semantics)."""
        planar = jnp.asarray(
            [[[200.7]], [[-5.2]], [[40000.5]]], dtype=jnp.float32
        )
        out16 = np.asarray(from_planar(planar, jnp.int16))
        np.testing.assert_array_equal(out16.ravel(), [201, -5, 32767])
        out32 = np.asarray(from_planar(planar, jnp.int32))
        np.testing.assert_array_equal(out32.ravel(), [201, -5, 40001])
        # float targets stay untouched (no rounding)
        outf = np.asarray(from_planar(planar, jnp.float32))
        np.testing.assert_allclose(outf.ravel(), [200.7, -5.2, 40000.5])

    def test_int32_target_saturates_at_range_edges(self):
        """32-bit targets: float32 cannot represent 2^31 - 1 (it rounds
        to 2^31), so the clip bound must be pulled INSIDE the range or
        out-of-range values would reach the int cast. Values at the top
        of range saturate positive — never wrap to INT_MIN."""
        planar = jnp.asarray([[[2.2e9]], [[-2.5e9]]], dtype=jnp.float32)
        out = np.asarray(from_planar(planar, jnp.int32)).ravel()
        assert out[0] > 2_147_000_000  # saturated high, not wrapped
        assert out[1] == np.iinfo(np.int32).min
