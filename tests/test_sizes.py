"""FFT size planner parity with Utils.hpp:141-157."""

import numpy as np

from blur_algorithms.ops import sizes


def _ref_is_valid(n: int) -> bool:
    # direct transcription of the reference rule for brute-force comparison
    n_min = 32
    r = n
    while r >= 5 * n_min and r % 5 == 0:
        r //= 5
    while r >= 3 * n_min and r % 3 == 0:
        r //= 3
    while r >= 2 * n_min and r % 2 == 0:
        r //= 2
    return r == n_min


def test_is_valid_brute_force():
    for n in range(1, 4096):
        assert sizes.is_valid_size(n) == _ref_is_valid(n)


def test_known_valid_sizes():
    for n in [32, 64, 96, 160, 480, 1024, 2048, 1080 + 2 * 84]:
        if _ref_is_valid(n):
            assert sizes.is_valid_size(n)
    assert not sizes.is_valid_size(33)
    assert not sizes.is_valid_size(224)  # 224 = 32*7


def test_nearest_transform_size():
    for n in [1, 31, 32, 33, 100, 223, 1000, 1921, 4000, 12345]:
        m = sizes.nearest_transform_size(n)
        assert m >= max(n, 32)
        assert m % 32 == 0
        assert sizes.is_valid_size(m)
        # minimality in steps of 32
        k = max(32, 32 * ((n + 31) // 32))
        while k < m:
            assert not sizes.is_valid_size(k)
            k += 32


def test_next_pow2():
    assert sizes.next_pow2(1) == 32
    assert sizes.next_pow2(32) == 32
    assert sizes.next_pow2(33) == 64
    assert sizes.next_pow2(4097) == 8192


def test_plan_modes():
    assert sizes.plan_fft_size(1000, "smooth235") == sizes.nearest_transform_size(1000)
    assert sizes.plan_fft_size(1000, "pow2") == 1024
    np.testing.assert_raises(ValueError, sizes.plan_fft_size, 10, "bogus")


def test_plan_fft_size_auto_mode():
    """auto = smooth235, the reference's padding policy, on every backend;
    pow2 stays an explicit mode."""
    from blur_algorithms.ops import sizes

    for n in (480, 1000, 1050, 5000, 30000):
        assert sizes.plan_fft_size(n, "auto") == sizes.plan_fft_size(n, "smooth235")
    assert sizes.plan_fft_size(480, "auto") == 480
    assert sizes.plan_fft_size(480, "pow2") == 512


def test_auto_is_default_mode():
    assert sizes.SIZE_MODES[0] == "auto"
    assert sizes.plan_fft_size(1000) == sizes.plan_fft_size(1000, "auto")
