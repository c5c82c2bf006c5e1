"""Regenerate the reference's spectrum-analysis sweep in JAX.

The reference ships ~145 MB of images under ``test_images/spectrum_analysis``
(blur radius 0-200 and noise 10-200 sweeps of spatial / frequency-domain
collages, produced with its ``DFT_image`` compile mode). This example
reproduces that study as a script: blur an input at a sweep of sigmas,
export each log-magnitude spectrum, and write a collage strip — visual
verification that blur attenuates high frequencies.

Usage: python examples/spectrum_sweep.py <image> [--sigmas 0 5 20 80]
       [--noises 0 25 100] [--out spectrum_collage.png]

``--noises`` reproduces the reference's second study axis
(``test_images/spectrum_analysis/noisy``): additive Gaussian noise raises
the spectrum floor uniformly where blur collapses it toward DC.
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
    p.add_argument("--sigmas", nargs="+", type=float, default=[0.5, 5, 20, 80])
    p.add_argument("--noises", nargs="+", type=float, default=[],
                   help="additive Gaussian noise stddevs (the reference's "
                        "'noisy' sweep, radius fixed at --sigmas[0])")
    p.add_argument("--out", default="spectrum_collage.png")
    p.add_argument("--max-dim", type=int, default=512,
                   help="downscale long side to keep the collage small")
    args = p.parse_args()

    import jax.numpy as jnp

    from blur_algorithms import blur_u8
    from blur_algorithms.models.pipeline import SpectrumAnalyzer
    from blur_algorithms.utils import io

    img = io.read_image(args.image)
    h, w = img.shape[:2]
    scale = max(h, w) / args.max_dim
    if scale > 1:
        ys = np.linspace(0, h - 1, int(h / scale)).astype(int)
        xs = np.linspace(0, w - 1, int(w / scale)).astype(int)
        img = img[ys][:, xs]

    analyzer = SpectrumAnalyzer()
    rows = []

    def strip(frame: np.ndarray, label: str) -> None:
        spec_vis = analyzer.to_image(np.asarray(analyzer(frame)))
        # pad/crop the spectrum to the image height for a clean strip
        sh, sw = spec_vis.shape[:2]
        ih, iw = frame.shape[:2]
        spec_crop = (
            spec_vis[:ih, :iw] if (sh >= ih and sw >= iw) else np.zeros_like(frame)
        )
        rows.append(np.concatenate([frame, spec_crop], axis=1))
        print(f"{label}: spatial std {frame.std():.1f}, "
              f"spectrum mean {np.asarray(spec_vis).mean():.1f}")

    # the whole sigma sweep is ONE compiled dispatch (shared forward FFT,
    # per-sigma spectra batched) — the reference loop recompiles per sigma
    from blur_algorithms import blur_multi_sigma_u8

    sweep = np.asarray(
        blur_multi_sigma_u8(
            jnp.asarray(img), [max(s, 0.1) for s in args.sigmas]
        )
    )
    for sigma, frame in zip(args.sigmas, sweep):
        strip(frame, f"sigma={sigma}")

    noise_rng = np.random.default_rng(0)
    for noise in args.noises:
        noisy = np.clip(
            img.astype(np.float32) + noise_rng.normal(0, noise, img.shape),
            0, 255,
        ).astype(np.uint8)
        base = max(args.sigmas[0], 0.1) if args.sigmas else 0.1
        strip(np.asarray(blur_u8(jnp.asarray(noisy), base)),
              f"noise={noise}")

    collage = np.concatenate(rows, axis=0)
    io.write_image(args.out, collage)
    print(f"wrote {args.out} ({collage.shape[1]}x{collage.shape[0]})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
