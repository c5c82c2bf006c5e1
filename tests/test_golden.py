"""Golden-output CRC tests — what the reference's dormant crc32c was for.

The CPU oracle is deterministic (NumPy pocketfft, fixed inputs), so its
outputs are pinned by CRC-32. These catch any silent change to the kernel
math, padding geometry, rounding, or spectrum indexing.
"""

import numpy as np

from blur_algorithms import oracle
from blur_algorithms.ops import kernels
from blur_algorithms.ops.plan import make_plan


def _fixed_image(h=64, w=80, c=3):
    # deterministic structured image; independent of numpy RNG evolution
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack(
        [
            (xx * 3 + yy * 7) % 256,
            (xx * xx // 5 + yy * 2) % 256,
            (xx + yy * yy // 3) % 256,
        ],
        axis=-1,
    )
    return img.astype(np.uint8)


def test_golden_blur_sigma5():
    out = oracle.blur_u8(_fixed_image(), 5.0)
    assert oracle.crc32c(out) == 0x000A67F4, hex(oracle.crc32c(out))


def test_golden_blur_sigma20():
    out = oracle.blur_u8(_fixed_image(), 20.0)
    assert oracle.crc32c(out) == 0x39F81144, hex(oracle.crc32c(out))


def test_golden_box_kernel_plan():
    plan = make_plan((64, 80), 3.0, kernel="box")
    assert oracle.crc32c(plan.row.taps) == 0xEA878E7D, hex(
        oracle.crc32c(plan.row.taps)
    )


def test_golden_gaussian_taps():
    taps = kernels.gaussian_kernel(10.0, 65)
    assert oracle.crc32c(taps) == 0x13FBA9ED, hex(oracle.crc32c(taps))


def test_golden_spectrum():
    img = _fixed_image()[..., 0].astype(np.float32)
    plan = make_plan((64, 80), 2.0)
    spec = oracle.dft_spectrum_np(img, plan)
    assert oracle.crc32c(spec) == 0x6431716B, hex(oracle.crc32c(spec))
