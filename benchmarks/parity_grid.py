"""Parity certification: every engine vs the CPU pocketfft oracle.

Runs a sigma x engine grid (and a radius grid for the box paths) on the
current backend, comparing uint8 outputs against ``oracle.blur_u8`` /
naive box convolution. Writes ``benchmarks/parity_grid.json`` and prints a
table. The acceptance gate matches BASELINE.json: max abs err <= 1 uint8
count.

The output names the device it ran on. Usage:

    python benchmarks/parity_grid.py [--hw 333 444] [--fuzz N]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--hw", nargs=2, type=int, default=[333, 444])
    p.add_argument("--out", default="benchmarks/parity_grid.json")
    p.add_argument("--fuzz", type=int, default=0, metavar="N",
                   help="append N randomized (shape, sigma, engine) cases")
    p.add_argument("--seed", type=int, default=11)
    args = p.parse_args()

    import jax
    import jax.numpy as jnp

    from blur_algorithms import Engine, blur_u8, box_blur, oracle

    h, w = args.hw
    rng = np.random.default_rng(3)
    yy, xx = np.mgrid[0:h, 0:w]
    base = 127 + 70 * np.sin(xx / 9.0) + 50 * np.cos(yy / 13.0) + rng.normal(0, 20, (h, w))
    img = np.clip(
        np.stack([base, np.roll(base, 11, 0), np.roll(base, 5, 1)], -1), 0, 255
    ).astype(np.uint8)
    xj = jnp.asarray(img)

    # sigma 200 on the default 333x444 grid clamps to asymmetric radii
    # (col 332, row 443) — a multi-block-halo stressor for the fused kernel
    sigmas = [0.5, 1.0, 2.0, 5.0, 10.0, 20.0, 50.0, 100.0, 200.0]
    engines = [
        Engine.FFT2,
        Engine.FFT_TILES,
        Engine.CONV,
        Engine.BAND,
        Engine.FUSED,
        Engine.FFT_MXU,
    ]
    rows = []
    worst = 0
    for sigma in sigmas:
        want = oracle.blur_u8(img, sigma)
        for eng in engines:
            got = np.asarray(blur_u8(xj, sigma, engine=eng))
            d = np.abs(got.astype(int) - want.astype(int))
            row = {
                "case": f"gaussian s={sigma} {eng.value}",
                "max": int(d.max()),
                "exact": round(float((d == 0).mean()), 5),
            }
            rows.append(row)
            worst = max(worst, row["max"])
            print(json.dumps(row), flush=True)

    # deriche recursive engine: an approximation, held to the same gate
    from blur_algorithms.ops.deriche import deriche_applicable

    for sigma in [16.0, 30.0, 60.0]:
        if not deriche_applicable((h, w), sigma):
            continue
        want = oracle.blur_u8(img, sigma)
        got = np.asarray(blur_u8(xj, sigma, engine=Engine.DERICHE))
        d = np.abs(got.astype(int) - want.astype(int))
        row = {
            "case": f"gaussian s={sigma} deriche",
            "max": int(d.max()),
            "exact": round(float((d == 0).mean()), 5),
        }
        rows.append(row)
        worst = max(worst, row["max"])
        print(json.dumps(row), flush=True)

    # multi-sigma sweep: every slice of the one-dispatch sweep must match
    # the per-sigma oracle like a standalone blur would
    from blur_algorithms import blur_multi_sigma_u8

    ms_sigmas = [1.0, 8.0, 40.0]
    ms_out = np.asarray(blur_multi_sigma_u8(xj, ms_sigmas))
    for i, sigma in enumerate(ms_sigmas):
        want = oracle.blur_u8(img, sigma)
        d = np.abs(ms_out[i].astype(int) - want.astype(int))
        row = {
            "case": f"multi_sigma[{i}] s={sigma}",
            "max": int(d.max()),
            "exact": round(float((d == 0).mean()), 5),
        }
        rows.append(row)
        worst = max(worst, row["max"])
        print(json.dumps(row), flush=True)

    # pffft flag-3 emulation vs ITS OWN NumPy twin (the Nyquist shortcut
    # deviates from the pocketfft oracle on Nyquist-heavy content by design,
    # so the twin — not blur_u8's oracle — is the right anchor)
    from blur_algorithms.ops.plan import make_plan

    for sigma in [2.0, 10.0, 50.0]:
        plan = make_plan((h, w), sigma)  # same auto sizing the engine plans
        chw = np.moveaxis(img, -1, 0).astype(np.float32)
        twin_f = oracle.blur_planar_pffft(chw, plan)
        want = np.clip(
            np.floor(np.moveaxis(twin_f, 0, -1) + 0.5), 0, 255
        ).astype(np.uint8)
        got = np.asarray(blur_u8(xj, sigma, engine=Engine.PFFFT))
        d = np.abs(got.astype(int) - want.astype(int))
        row = {
            "case": f"pffft-twin s={sigma}",
            "max": int(d.max()),
            "exact": round(float((d == 0).mean()), 5),
        }
        rows.append(row)
        worst = max(worst, row["max"])
        print(json.dumps(row), flush=True)

    # anisotropic gaussian: per-axis sigmas through AUTO and the parity
    # engines vs the same-pair oracle (the oracle's make_plan builds the
    # identical per-axis taps/spectra)
    for sy, sx in [(2.0, 8.0), (15.0, 1.0), (40.0, 90.0)]:
        want = oracle.blur_u8(img, (sy, sx))
        for eng in [Engine.AUTO, Engine.FFT2, Engine.FUSED]:
            got = np.asarray(blur_u8(xj, (sy, sx), engine=eng))
            d = np.abs(got.astype(int) - want.astype(int))
            row = {
                "case": f"aniso sy={sy} sx={sx} {eng.value}",
                "max": int(d.max()),
                "exact": round(float((d == 0).mean()), 5),
            }
            rows.append(row)
            worst = max(worst, row["max"])
            print(json.dumps(row), flush=True)

    # box paths vs naive sequential box convolution

    for n in [1.0, 2.0, 4.0, 10.0]:
        got = np.asarray(box_blur(xj, n))
        plan = make_plan((h, w), int(n * n), kernel="box_fast", box_passes=2)
        want_f = oracle.blur_direct(np.moveaxis(img, -1, 0).astype(np.float32), plan)
        want = np.clip(np.floor(np.moveaxis(want_f, 0, -1) + 0.5), 0, 255).astype(int)
        d = np.abs(got.astype(int) - want)
        row = {"case": f"box n={n} (r={int(n*n)})", "max": int(d.max()),
               "exact": round(float((d == 0).mean()), 5)}
        rows.append(row)
        worst = max(worst, row["max"])
        print(json.dumps(row), flush=True)

    # randomized fuzz on the SAME backend: odd/even
    # dims, elongated frames, log-uniform sigma, every planar engine
    if args.fuzz:
        frng = np.random.default_rng(args.seed)
        fuzz_engines = engines + [Engine.AUTO]
        for i in range(args.fuzz):
            fh = int(frng.integers(17, 500))
            fw = int(frng.integers(17, 500))
            sigma = float(np.exp(frng.uniform(np.log(0.5), np.log(150.0))))
            eng = fuzz_engines[int(frng.integers(len(fuzz_engines)))]
            fimg = (frng.random((fh, fw, 3)) * 255).astype(np.uint8)
            got = np.asarray(blur_u8(jnp.asarray(fimg), sigma, engine=eng))
            want = oracle.blur_u8(fimg, sigma)
            d = np.abs(got.astype(int) - want.astype(int))
            row = {
                "case": f"fuzz[{i}] {fh}x{fw} s={sigma:.2f} {eng.value}",
                "max": int(d.max()),
                "exact": round(float((d == 0).mean()), 5),
            }
            rows.append(row)
            worst = max(worst, row["max"])
            print(json.dumps(row), flush=True)

        # custom-tap fuzz: random odd-length taps, signed/asymmetric
        # included, vs the direct-convolution oracle (absolute gate: taps
        # scale ~unit-sum, so 1 count stays the right tolerance class)
        from blur_algorithms import convolve_separable
        from blur_algorithms.ops.plan import make_custom_plan

        for i in range(max(4, args.fuzz // 3)):
            fh = int(frng.integers(24, 300))
            fw = int(frng.integers(24, 300))
            nr = int(frng.integers(1, 12)) * 2 + 1
            nc = int(frng.integers(1, 12)) * 2 + 1
            tr = frng.normal(0, 0.4, nr).astype(np.float32)
            tc = frng.normal(0, 0.4, nc).astype(np.float32)
            kind = int(frng.integers(3))
            if kind == 0:  # blur-like: non-negative unit-sum (int8 path)
                tr, tc = np.abs(tr), np.abs(tc)
                tr, tc = tr / tr.sum(), tc / tc.sum()
            elif kind == 1:  # symmetric signed (sharpen-like)
                tr, tc = (tr + tr[::-1]) / 2, (tc + tc[::-1]) / 2
                tr, tc = tr / np.abs(tr).sum(), tc / np.abs(tc).sum()
            else:  # fully asymmetric (complex-spectrum FFT route)
                tr, tc = tr / np.abs(tr).sum(), tc / np.abs(tc).sum()
            eng = [Engine.AUTO, Engine.FUSED, Engine.FFT2, Engine.BAND][
                int(frng.integers(4))
            ]
            fimg = (frng.random((fh, fw, 3)) * 255).astype(np.uint8)
            got = np.asarray(
                convolve_separable(jnp.asarray(fimg), tr, tc, engine=eng)
            )
            plan = make_custom_plan((fh, fw), tr, tc)
            want_f = oracle.blur_direct(
                np.moveaxis(fimg, -1, 0).astype(np.float32), plan
            )
            want = np.clip(
                np.floor(np.moveaxis(want_f, 0, -1) + 0.5), 0, 255
            ).astype(int)
            d = np.abs(got.astype(int) - want)
            row = {
                "case": f"custom_fuzz[{i}] {fh}x{fw} taps {nr}x{nc} "
                f"kind={('blur', 'sym', 'asym')[kind]} {eng.value}",
                "max": int(d.max()),
                "exact": round(float((d == 0).mean()), 5),
            }
            rows.append(row)
            worst = max(worst, row["max"])
            print(json.dumps(row), flush=True)

    summary = {
        "backend": jax.default_backend(),
        "image": [h, w, 3],
        "worst_max_abs_err": worst,
        "gate": "max <= 1",
        "pass": worst <= 1,
        "cases": rows,
    }

    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(summary, f, indent=1)
    ok = worst <= 1
    print(f"\nworst max abs err: {worst}  gate(max<=1): {'PASS' if worst <= 1 else 'FAIL'}")
    print(f"wrote {args.out}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
