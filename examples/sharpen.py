"""Unsharp-mask demo: the blur as a building block of photographic clean-up.

The reference's comparison corpora (``test_images/Clean Up Comparisons``)
study blur recipes for image clean-up; this example shows the inverse
composite on the same corpus — sharpening via the blur:

    out = x + amount * (x - gaussian_blur(x))        (unsharp masking)

plus the signed high-pass residual itself, visualized around mid-gray.

Usage: python examples/sharpen.py <image> [--sigma 2.0] [--amount 1.2]
       [--out sharpen_demo.jpg]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("image")
    p.add_argument("--sigma", type=float, default=2.0)
    p.add_argument("--amount", type=float, default=1.2)
    p.add_argument("--threshold", type=int, default=0)
    p.add_argument("--out", default="sharpen_demo.jpg")
    p.add_argument("--max-dim", type=int, default=900)
    args = p.parse_args()

    import jax.numpy as jnp

    from blur_algorithms.models import high_pass, unsharp_mask
    from blur_algorithms.utils import io

    img = io.read_image(args.image)
    h, w = img.shape[:2]
    scale = max(h, w) / args.max_dim
    if scale > 1:
        try:
            import cv2

            img = cv2.resize(img, (int(w / scale), int(h / scale)))
        except ImportError:
            step = int(np.ceil(scale))
            img = img[::step, ::step]

    x = jnp.asarray(img)
    sharp = np.asarray(
        unsharp_mask(x, args.sigma, args.amount, threshold=args.threshold)
    )
    hp = np.asarray(high_pass(x, args.sigma))  # (C, H, W) float, signed
    hp_vis = np.clip(
        np.moveaxis(hp, 0, -1) * 2.0 + 128.0, 0, 255
    ).astype(np.uint8)

    collage = np.concatenate([img, sharp, hp_vis], axis=1)
    io.write_image(args.out, collage)
    print(
        f"wrote {args.out}: original | unsharp(sigma={args.sigma}, "
        f"amount={args.amount}) | high-pass residual (x2, around mid-gray)"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
