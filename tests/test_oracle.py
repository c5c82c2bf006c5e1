"""Oracle self-consistency: FFT path vs independent direct convolution,
plus the blur invariants SURVEY.md §4 prescribes (DC preservation,
near-identity at tiny sigma, separability)."""

import numpy as np

from blur_algorithms import oracle
from blur_algorithms.ops.plan import make_plan


def test_fft2_matches_direct_convolution(rng):
    x = rng.random((2, 37, 29)).astype(np.float32) * 255
    for nsmooth in [1.5, 4.0, 9.0]:
        plan = make_plan((37, 29), nsmooth)
        got = oracle.blur_planar_fft2(x, plan)
        want = oracle.blur_direct(x, plan)
        np.testing.assert_allclose(got, want, atol=2e-3)


def test_box_kernel_fft_matches_direct(rng):
    x = rng.random((31, 33)).astype(np.float32) * 255
    plan = make_plan((31, 33), 3.0, kernel="box")  # tent of box k=9
    got = oracle.blur_planar_fft2(x, plan)
    want = oracle.blur_direct(x, plan)
    np.testing.assert_allclose(got, want, atol=2e-3)


def test_dc_preserved(rng):
    x = rng.random((48, 64)).astype(np.float32) * 255
    plan = make_plan((48, 64), 6.0)
    out = oracle.blur_planar_fft2(x, plan)
    # blur preserves the mean up to border effects; constant image exactly
    const = np.full((48, 64), 131.25, dtype=np.float32)
    out_c = oracle.blur_planar_fft2(const, plan)
    np.testing.assert_allclose(out_c, const, atol=1e-2)
    assert out.shape == x.shape


def test_tiny_sigma_is_near_identity(rgb_image):
    out = oracle.blur_u8(rgb_image, 0.3)
    diff = np.abs(out.astype(int) - rgb_image.astype(int))
    assert diff.max() <= 1


def test_separability(rng):
    # 2-D blur == rows pass then cols pass with the same 1-D taps
    x = rng.random((40, 56)).astype(np.float32) * 255
    plan = make_plan((40, 56), 5.0)
    full = oracle.blur_direct(x, plan)

    radius_r = plan.row.support_radius
    padded = oracle.reflect_101_np(x, [(radius_r, radius_r)], axes=[-1])
    rows = np.zeros_like(x, dtype=np.float64)
    for t, tap in enumerate(plan.row.taps.astype(np.float64)):
        rows += tap * padded[:, t : t + 56]
    radius_c = plan.col.support_radius
    padded = oracle.reflect_101_np(rows, [(radius_c, radius_c)], axes=[-2])
    cols = np.zeros_like(x, dtype=np.float64)
    for t, tap in enumerate(plan.col.taps.astype(np.float64)):
        cols += tap * padded[t : t + 40, :]
    np.testing.assert_allclose(full, cols, atol=1e-9)


def test_monotone_smoothing(rgb_image):
    # larger sigma -> lower variance
    variances = [
        np.var(oracle.blur_u8(rgb_image, s).astype(np.float64))
        for s in [1.0, 3.0, 8.0]
    ]
    assert variances[0] > variances[1] > variances[2]


def test_crc32c_known_vector():
    # CRC-32 ("123456789") with poly 0xEDB88320 == 0xCBF43926
    data = np.frombuffer(b"123456789", dtype=np.uint8)
    assert oracle.crc32c(data) == 0xCBF43926
    # two-buffer form concatenates, like the reference's (data, data1) overload
    assert oracle.crc32c(data[:4], data[4:]) == 0xCBF43926


def test_opencv_gaussian_parity(rgb_image):
    """cv::GaussianBlur is the reference's own informal oracle
    (Source.cpp:602). With a matched kernel size and reflect-101 border the
    outputs should agree within quantization."""
    import cv2

    from blur_algorithms.ops.kernels import gaussian_window

    sigma = 4.0
    width = gaussian_window(sigma, max(rgb_image.shape[:2]))
    ours = oracle.blur_u8(rgb_image, sigma)
    ref = cv2.GaussianBlur(
        rgb_image, (width, width), sigma, borderType=cv2.BORDER_REFLECT_101
    )
    diff = np.abs(ours.astype(int) - ref.astype(int))
    assert diff.max() <= 2
    assert (diff <= 1).mean() > 0.99
