"""Minimal production-serving frontend: HTTP blur service over BlurPipeline.

The reference is a one-shot CLI (``Source.cpp:611-641``); this is the same
pipeline in its serving shape: a threaded stdlib HTTP server in front of
shape-bucketed, recompile-free compiled programs (``models/pipeline.py``),
with optional startup warmup so no live request pays an XLA compile.

Zero dependencies beyond the framework (stdlib ``http.server``; image
decode via ``utils/io`` — PIL/cv2 when present, PPM-P6/NPY always).

    python examples/serve.py [--port 8700] [--sigma 10] [--engine auto]
                             [--warmup 1080p 4k]

API:
    POST /blur?sigma=10&engine=auto&kernel=gaussian   body: image bytes
        -> blurred image bytes (same container format as the request)
    GET  /healthz -> {"status": "ok", "backend": ..., "pipelines": {...}}

One ``BlurPipeline`` is cached per (sigma, engine, kernel); concurrent
requests serialize their DISPATCH around the device via a lock (JAX
dispatch is async — the lock covers enqueue, not completion, so the device
stays busy across requests), while a cold bucket's synchronous XLA compile
runs before that lock so it never blocks other requests or ``/healthz``
(which takes only the short cache lock). Each pipeline's bucketing keeps
distinct XLA programs bounded regardless of client frame sizes.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from blur_algorithms.models.pipeline import BlurPipeline
from blur_algorithms.utils.io import decode_image, encode_image

_WARMUP_NAMES = {"720p": (720, 1280), "1080p": (1080, 1920),
                 "1440p": (1440, 2560), "4k": (2160, 3840)}


class BlurService:
    """Pipeline cache + device lock shared by all request threads.

    Two locks: ``_cache_lock`` (short — pipeline dict + counters; what
    ``/healthz`` takes) and ``_device_lock`` (dispatch only). A cold shape
    bucket's XLA compile runs via ``pipe.ensure_compiled`` BEFORE the
    device lock is taken, so a many-second compile never blocks health
    checks or other requests' dispatch — concurrent compiles of the same
    program are deduplicated by XLA's own compilation cache.
    """

    def __init__(self, max_pipelines: int = 32):
        self._pipelines: dict[tuple, BlurPipeline] = {}
        self._cache_lock = threading.Lock()
        self._device_lock = threading.Lock()
        self._max = int(max_pipelines)
        self.requests = 0

    def pipeline(self, sigma: float, engine: str, kernel: str) -> BlurPipeline:
        key = (round(float(sigma), 4), engine, kernel)
        with self._cache_lock:
            pipe = self._pipelines.get(key)
            if pipe is None:
                if len(self._pipelines) >= self._max:
                    raise ValueError(
                        f"pipeline cache full ({self._max}); vary sigma less "
                        "or raise --max-pipelines"
                    )
                pipe = BlurPipeline(sigma, engine=engine, kernel=kernel)
                self._pipelines[key] = pipe
            return pipe

    def blur(self, body: bytes, fmt: str, sigma: float, engine: str,
             kernel: str) -> bytes:
        img = decode_image(body, fmt)
        pipe = self.pipeline(sigma, engine, kernel)
        # cold bucket -> compile here, outside the device lock
        pipe.ensure_compiled(
            img.shape[-3], img.shape[-2], channels=img.shape[-1],
            batch=img.shape[:-3],
        )
        with self._device_lock:  # covers dispatch; async device work overlaps
            out = pipe(img)
        with self._cache_lock:
            self.requests += 1
        return encode_image(np.asarray(out), fmt)

    def stats(self) -> dict:
        import jax

        with self._cache_lock:
            return {
                "status": "ok",
                "backend": jax.default_backend(),
                "requests": self.requests,
                "pipelines": {
                    f"sigma={k[0]} engine={k[1]} kernel={k[2]}": p.stats
                    for k, p in self._pipelines.items()
                },
            }


def make_handler(service: BlurService):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet by default
            pass

        def _send(self, code: int, body: bytes, ctype: str):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _error(self, code: int, msg: str):
            self._send(code, json.dumps({"error": msg}).encode(),
                       "application/json")

        def do_GET(self):
            if urlparse(self.path).path != "/healthz":
                return self._error(404, "unknown path (try /healthz)")
            self._send(200, json.dumps(service.stats()).encode(),
                       "application/json")

        def do_POST(self):
            url = urlparse(self.path)
            if url.path != "/blur":
                return self._error(404, "unknown path (try POST /blur)")
            q = parse_qs(url.query)

            def one(name, default):
                return q.get(name, [default])[-1]

            try:
                sigma = float(one("sigma", "10"))
                engine = one("engine", "auto")
                kernel = one("kernel", "gaussian")
                fmt = one("format", "png").lstrip(".").lower()
                n = int(self.headers.get("Content-Length", 0))
                if n <= 0:
                    return self._error(400, "empty body (send image bytes)")
                body = self.rfile.read(n)
                out = service.blur(body, fmt, sigma, engine, kernel)
            except ValueError as e:
                return self._error(400, str(e))
            except Exception as e:  # noqa: BLE001 — report, keep serving
                return self._error(500, f"{type(e).__name__}: {e}")
            self._send(200, out, f"image/{fmt}")

    return Handler


def serve(port: int = 8700, warmup=(), sigma: float = 10.0,
          engine: str = "auto", kernel: str = "gaussian",
          started: threading.Event | None = None):
    # restarts reload compiled programs from disk instead of re-paying the
    # warmup compiles
    from blur_algorithms.utils.cache import enable_persistent_cache

    enable_persistent_cache()
    service = BlurService()
    if warmup:
        pipe = service.pipeline(sigma, engine, kernel)
        shapes = [_WARMUP_NAMES.get(str(s).lower(), None) or
                  tuple(int(v) for v in str(s).split("x")) for s in warmup]
        print(f"warming up {shapes} ...", flush=True)
        pipe.warmup(shapes)
    httpd = ThreadingHTTPServer(("127.0.0.1", port), make_handler(service))
    httpd.service = service  # for tests
    if started is not None:
        started.set()
    print(f"serving on http://127.0.0.1:{httpd.server_address[1]} "
          f"(POST /blur?sigma=S&engine=E, GET /healthz)", flush=True)
    return httpd


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--port", type=int, default=8700)
    p.add_argument("--sigma", type=float, default=10.0,
                   help="sigma to warm up (requests may use any sigma)")
    p.add_argument("--engine", default="auto")
    p.add_argument("--kernel", default="gaussian")
    p.add_argument("--warmup", nargs="*", default=(),
                   help="shapes to pre-compile: 720p/1080p/4k or HxW")
    args = p.parse_args()
    httpd = serve(args.port, args.warmup, args.sigma, args.engine, args.kernel)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    return 0


if __name__ == "__main__":
    sys.exit(main())
