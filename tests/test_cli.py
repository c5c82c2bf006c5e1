"""CLI end-to-end: reference positional form, engines, spectrum mode, IO."""

import subprocess
import sys

import numpy as np
import pytest

from blur_algorithms.cli import main
from blur_algorithms.utils import io


@pytest.fixture
def ppm_image(tmp_path, rgb_image):
    path = tmp_path / "in.ppm"
    io.write_image(str(path), rgb_image)
    return path


def test_ppm_round_trip(tmp_path, rgb_image):
    path = tmp_path / "x.ppm"
    io.write_image(str(path), rgb_image)
    np.testing.assert_array_equal(io.read_image(str(path)), rgb_image)


def test_npy_round_trip(tmp_path, rgb_image):
    path = tmp_path / "x.npy"
    io.write_image(str(path), rgb_image)
    np.testing.assert_array_equal(io.read_image(str(path)), rgb_image)


def test_reference_flag_form(ppm_image, tmp_path, rgb_image):
    out = tmp_path / "out.ppm"
    assert main(["3", "5", str(ppm_image), "-o", str(out)]) == 0
    blurred = io.read_image(str(out))
    assert blurred.shape == rgb_image.shape
    assert blurred.std() < rgb_image.std()


def test_named_engine_and_box(ppm_image, tmp_path):
    out = tmp_path / "box.ppm"
    assert main(["box", "2", str(ppm_image), "-o", str(out)]) == 0
    assert io.read_image(str(out)).shape == io.read_image(str(ppm_image)).shape


def test_spectrum_mode(ppm_image, tmp_path):
    out = tmp_path / "spec.npy"
    assert main(["2", "1", str(ppm_image), "--spectrum", "-o", str(out)]) == 0
    spec = np.load(str(out))
    assert spec.ndim == 3 and spec.dtype == np.uint8


def test_default_output_name(ppm_image):
    assert main(["1", "3", str(ppm_image)]) == 0
    expected = str(ppm_image)[:-4] + "_blurred.ppm"
    assert io.read_image(expected).shape == io.read_image(str(ppm_image)).shape


def test_bad_flag_exits(ppm_image):
    with pytest.raises(SystemExit):
        main(["9", "3", str(ppm_image)])


def test_module_invocation(ppm_image, tmp_path):
    out = tmp_path / "m.ppm"
    proc = subprocess.run(
        [sys.executable, "-m", "blur_algorithms", "band", "4", str(ppm_image),
         "-o", str(out)],
        capture_output=True, text=True, timeout=600,
        env={**__import__("os").environ, "JAX_PLATFORMS": "cpu"},
    )
    assert proc.returncode == 0, proc.stderr
    assert out.exists()


def test_directory_mode(tmp_path, rgb_image):
    src = tmp_path / "frames"
    src.mkdir()
    for i in range(3):
        io.write_image(str(src / f"f{i}.ppm"), rgb_image)
    out_dir = tmp_path / "out"
    assert main(["auto", "4", str(src), "-o", str(out_dir)]) == 0
    outs = sorted(p.name for p in out_dir.iterdir())
    assert outs == ["f0.ppm", "f1.ppm", "f2.ppm"]
    got = io.read_image(str(out_dir / "f0.ppm"))
    assert got.shape == rgb_image.shape and not np.array_equal(got, rgb_image)


def test_directory_mode_rejects_bench(tmp_path, rgb_image):
    src = tmp_path / "frames"
    src.mkdir()
    io.write_image(str(src / "a.ppm"), rgb_image)
    with pytest.raises(SystemExit):
        main(["auto", "4", str(src), "--bench", "3"])


def test_directory_mode_empty_dir(tmp_path):
    src = tmp_path / "empty"
    src.mkdir()
    with pytest.raises(SystemExit):
        main(["auto", "4", str(src)])


def test_sigmas_sweep_mode(ppm_image, tmp_path, rgb_image):
    """--sigmas: one dispatch, one file per sigma, each == the single blur."""
    out = tmp_path / "sweep.ppm"
    assert main(["auto", "1", str(ppm_image), "-o", str(out),
                 "--sigmas", "2", "5.5"]) == 0
    from blur_algorithms import oracle

    for s, tag in ((2.0, "2"), (5.5, "5p5")):
        got = io.read_image(str(tmp_path / f"sweep_s{tag}.ppm"))
        want = oracle.blur_u8(rgb_image, s)
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_sigmas_rejects_incompatible_modes(ppm_image):
    with pytest.raises(SystemExit):
        main(["auto", "1", str(ppm_image), "--sigmas", "2", "--spectrum"])
    with pytest.raises(SystemExit):
        main(["auto", "1", str(ppm_image), "--sigmas", "2",
              "--kernel", "box"])
