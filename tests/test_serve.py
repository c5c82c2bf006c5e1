"""HTTP serving example (examples/serve.py): end-to-end over a socket.

The served result must match the pocketfft oracle to <= 1 uint8 count —
the pipeline's margin-inclusive bucketing is exact, so the bucket pad it
adds cannot move any output pixel.
"""

import json
import sys
import threading
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "examples"))

from blur_algorithms import oracle
from blur_algorithms.utils.io import decode_image, encode_image


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    import serve as serve_mod

    # keep the server's persistent-cache side effect inside tmp_path: the
    # process-wide XLA cache singleton binds to the first dir used, and the
    # suite must not write into the user's real ~/.cache
    import os

    os.environ["JAX_COMPILATION_CACHE_DIR"] = str(
        tmp_path_factory.mktemp("xla_cache")
    )
    started = threading.Event()
    httpd = serve_mod.serve(port=0, started=started)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    started.wait(10)
    yield f"http://127.0.0.1:{httpd.server_address[1]}"
    httpd.shutdown()
    t.join(10)


def test_blur_roundtrip_matches_oracle(server, rng):
    img = (rng.random((256, 256, 3)) * 255).astype(np.uint8)
    body = encode_image(img, "ppm")
    req = urllib.request.Request(
        f"{server}/blur?sigma=4&format=ppm", data=body, method="POST"
    )
    with urllib.request.urlopen(req, timeout=120) as resp:
        assert resp.status == 200
        out = decode_image(resp.read(), "ppm")
    want = oracle.blur_u8(img, 4.0)
    d = np.abs(out.astype(int) - want.astype(int))
    assert d.max() <= 1
    assert (d == 0).mean() > 0.99


def test_healthz_reports_pipelines(server):
    with urllib.request.urlopen(f"{server}/healthz", timeout=30) as resp:
        stats = json.loads(resp.read())
    assert stats["status"] == "ok"
    assert stats["requests"] >= 1
    assert any("sigma=4" in k for k in stats["pipelines"])


def test_bad_requests(server):
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(f"{server}/nope", timeout=30)
    assert e.value.code == 404
    req = urllib.request.Request(f"{server}/blur?sigma=3", data=b"",
                                 method="POST")
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=30)
    assert e.value.code == 400
    # undecodable body -> 400/500 class, server keeps serving
    req = urllib.request.Request(
        f"{server}/blur?sigma=3&format=ppm", data=b"garbage", method="POST"
    )
    with pytest.raises(urllib.error.HTTPError):
        urllib.request.urlopen(req, timeout=30)
    with urllib.request.urlopen(f"{server}/healthz", timeout=30) as resp:
        assert resp.status == 200


def test_codec_bytes_roundtrip(rng):
    img = (rng.random((20, 31, 3)) * 255).astype(np.uint8)
    for fmt in ("ppm", "npy"):
        np.testing.assert_array_equal(
            decode_image(encode_image(img, fmt), fmt), img
        )
