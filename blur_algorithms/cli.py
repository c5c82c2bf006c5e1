"""CLI — reference-compatible positional form plus a modern interface.

Reference ``main`` (``Source.cpp:611-641``): ``<flag> <nsmooth> <file>``
with flags 5=pocketfft_1D, 4=FastBoxBlur, 3=pffft, 2=pocketfft_2D,
1=baseline. Here the same positionals work (``blur 3 10 img.png``), engines
may also be named (``blur fft_tiles 10 img.png``), and unlike the reference
the output path, spectrum mode, benchmark sweep, and input validation are
first-class flags instead of hard-coded paths / compile-time macros.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from blur_algorithms.api import FLAG_TO_ENGINE, Engine


def _parse_engine(token: str) -> Engine:
    if token.isdigit():
        flag = int(token)
        if flag not in FLAG_TO_ENGINE:
            raise SystemExit(
                f"unknown engine flag {flag}; legend: "
                "5=fft_tiles(pocketfft_1D) 4=box(FastBoxBlur) "
                "3=fft_tiles(pffft) 2=fft2(pocketfft_2D) 1=conv(baseline)"
            )
        return FLAG_TO_ENGINE[flag]
    try:
        return Engine(token)
    except ValueError:
        raise SystemExit(
            f"unknown engine {token!r}; use a flag 1-5 or one of "
            f"{[e.value for e in Engine]}"
        )


def _nsmooth_arg(s: str):
    """CLI nsmooth: a float, or ``SYxSX`` for an anisotropic gaussian."""
    if "x" in s.lower():
        parts = s.lower().split("x")
        try:
            if len(parts) != 2:
                raise ValueError(s)
            return (float(parts[0]), float(parts[1]))
        except ValueError:
            raise argparse.ArgumentTypeError(
                f"bad nsmooth {s!r}: want a number or SYxSX (e.g. 5x11)"
            )
    return float(s)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="blur_algorithms",
        description="Gaussian/box blur via Fourier or direct convolution (JAX)",
    )
    p.add_argument("engine", help="engine flag 1-5 (reference legend) or name")
    p.add_argument("nsmooth", type=_nsmooth_arg,
                   help="sigma (gaussian; SYxSX, e.g. 5x11, for an "
                   "anisotropic blur) / n (box: r=n^2)")
    p.add_argument("file", help="input image (.png/.jpg/.ppm/.npy) or a directory "
                   "of images (streamed with prefetch)")
    p.add_argument("-o", "--output", default=None,
                   help="output path, or output directory in directory mode "
                   "(default: <in>_blurred[.<ext>])")
    p.add_argument("--kernel", choices=["gaussian", "box"], default="gaussian",
                   help="FFT-engine kernel; 'box' is the reference's #define boxblur tent mode")
    p.add_argument("--size-mode", choices=["auto", "smooth235", "pow2"],
                   default="auto",
                   help="FFT length planner: auto (= smooth235, reference "
                   "parity), smooth235, pow2")
    p.add_argument("--spectrum", action="store_true",
                   help="DFT_image mode: export the log-magnitude spectrum instead of blurring")
    p.add_argument("--bench", type=int, default=0, metavar="N",
                   help="time N repetitions and print ms / MP/s")
    p.add_argument("--sigmas", nargs="+", type=float, default=None,
                   metavar="S",
                   help="gaussian sigma sweep as ONE compiled dispatch "
                   "(shared forward FFT; overrides nsmooth; writes "
                   "<stem>_sS<ext> per sigma). The reference re-ran its "
                   "whole pipeline per sigma (Source.cpp:628-634)")
    return p


_IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".ppm", ".pnm", ".npy", ".tif", ".tiff")


def _stream_dir(args, engine: Engine) -> int:
    """Directory mode: blur every image via the prefetching stream pipeline."""
    import os

    from blur_algorithms.models.pipeline import BlurPipeline
    from blur_algorithms.utils import io

    paths = sorted(
        p
        for f in os.listdir(args.file)
        if f.lower().endswith(_IMAGE_EXTS)
        and os.path.isfile(p := os.path.join(args.file, f))
    )
    if not paths:
        raise SystemExit(f"error: no images in {args.file!r}")
    out_dir = args.output or (args.file.rstrip("/\\") + "_blurred")
    if os.path.realpath(out_dir) == os.path.realpath(args.file):
        raise SystemExit(
            "error: output directory equals the input directory; refusing "
            "to overwrite inputs in place (pass a different -o)"
        )
    os.makedirs(out_dir, exist_ok=True)

    # exact=True: identical results to single-file mode (one compile per
    # distinct frame shape — same as the single-file path); library users
    # can opt into bucketed shapes via BlurPipeline directly
    pipe = BlurPipeline(
        args.nsmooth, engine=engine, kernel=args.kernel,
        size_mode=args.size_mode, exact=True,
    )
    t0 = time.perf_counter()
    n = 0
    for key, out in pipe.stream(paths):
        io.write_image(
            os.path.join(out_dir, os.path.basename(str(key))), np.asarray(out)
        )
        n += 1
    dt = time.perf_counter() - t0
    print(
        f"{engine.value}: {n} frames in {dt * 1e3:.1f} ms "
        f"({pipe.stats['distinct_buckets']} compiled buckets) -> {out_dir}"
    )
    return 0


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    engine = _parse_engine(args.engine)

    # CLI runs are separate processes: persist compiled programs so repeat
    # invocations at one (shape, sigma, engine) skip the XLA compile
    # (cross-process analog of the reference's pocketfft plan cache,
    # Source.cpp:4-5)
    from blur_algorithms.utils.cache import enable_persistent_cache

    enable_persistent_cache()

    from blur_algorithms import api
    from blur_algorithms.utils import io

    import os

    if args.sigmas is not None and (
        args.spectrum or args.bench or args.kernel != "gaussian"
        or os.path.isdir(args.file)
    ):
        raise SystemExit(
            "error: --sigmas is single-file gaussian mode (no "
            "--spectrum/--bench/--kernel box/directory)"
        )

    if os.path.isdir(args.file):
        if args.spectrum or args.bench:
            raise SystemExit("error: --spectrum/--bench not supported in directory mode")
        return _stream_dir(args, engine)

    try:
        img = io.read_image(args.file)
    except (FileNotFoundError, OSError) as exc:
        # the reference segfaults on a bad path (Source.cpp:623 unchecked)
        raise SystemExit(f"error: cannot read image {args.file!r}: {exc}")
    if img.ndim == 2:
        img = img[..., None]
    h, w = img.shape[:2]

    if args.sigmas is not None:
        from blur_algorithms.ops.multi_sigma import blur_multi_sigma_u8

        t0 = time.perf_counter()
        outs = np.asarray(blur_multi_sigma_u8(
            img, args.sigmas, size_mode=args.size_mode
        ))
        print(f"multi_sigma x{len(args.sigmas)}: "
              f"{(time.perf_counter() - t0) * 1e3:.3f} ms "
              f"(one dispatch; first call includes compilation)")
        base = args.output or args.file
        dot = base.rfind(".")
        stem, ext = (base[:dot], base[dot:]) if dot > 0 else (base, ".png")
        for s, frame in zip(args.sigmas, outs):
            tag = f"{s:g}".replace(".", "p")
            sig_path = f"{stem}_s{tag}{ext}"
            io.write_image(sig_path, frame[..., 0] if frame.shape[-1] == 1
                           else frame)
            print(f"wrote {sig_path}")
        return 0

    if args.spectrum:
        if isinstance(args.nsmooth, tuple):
            raise SystemExit("error: --spectrum takes a single sigma")
        if args.nsmooth <= 0:
            raise SystemExit("error: --spectrum needs nsmooth > 0 (pad geometry)")
        from blur_algorithms.models.pipeline import SpectrumAnalyzer

        analyzer = SpectrumAnalyzer(args.nsmooth, size_mode=args.size_mode)
        out_img = analyzer.to_image(np.asarray(analyzer(img)))
        if out_img.shape[-1] == 1:
            out_img = out_img[..., 0]
    else:
        t0 = time.perf_counter()
        out = api.blur_u8(img, args.nsmooth, engine=engine,
                          kernel=args.kernel, size_mode=args.size_mode)
        out_img = np.asarray(out)
        # per-engine wall-ms print for reference-CLI parity (Source.cpp:267 etc.)
        print(f"{engine.value}: {(time.perf_counter() - t0) * 1e3:.3f} ms "
              f"(first call includes compilation)")

    if args.bench and not args.spectrum:
        from blur_algorithms.utils.timing import time_fn

        import jax.numpy as jnp

        def step(x):
            return api.blur_u8(x, args.nsmooth, engine=engine,
                               kernel=args.kernel, size_mode=args.size_mode)

        result = time_fn(step, jnp.asarray(img), iters=args.bench,
                         name=engine.value, megapixels=h * w / 1e6)
        print(result)

    out_path = args.output
    if out_path is None:
        dot = args.file.rfind(".")
        stem, ext = (args.file[:dot], args.file[dot:]) if dot > 0 else (args.file, ".png")
        out_path = f"{stem}_{'spectrum' if args.spectrum else 'blurred'}{ext}"
    io.write_image(out_path, out_img)
    print(f"wrote {out_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
