"""The ``pffft`` engine: exact flag-3 emulation incl. the Nyquist quirk.

The reference's pffft path multiplies the data's Nyquist bin by the
KERNEL'S DC VALUE (``Source.cpp:414-427``: the ordered real layout packs DC
at ``[0]`` / Nyquist at ``[1]`` and the pairwise multiply scales both halves
of each pair by ``kernel[2i]``). ``Engine.PFFFT`` reproduces that shortcut;
``oracle.blur_planar_pffft`` is its independent NumPy twin.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from blur_algorithms import Engine, blur, blur_u8, oracle
from blur_algorithms.ops.fft_conv import _pffft_quirked
from blur_algorithms.ops.plan import make_plan


def test_quirked_spectrum_edits_only_nyquist():
    spec = np.linspace(1.0, 0.0, 33).astype(np.float32)  # rfft of len 64
    q = _pffft_quirked(spec, 64)
    assert q[32] == spec[0]
    np.testing.assert_array_equal(q[:32], spec[:32])
    # odd lengths (no Nyquist bin) pass through untouched
    assert _pffft_quirked(spec, 63) is spec


@pytest.mark.parametrize("sigma", [2.0, 10.0, 50.0])
def test_pffft_engine_matches_numpy_twin(rgb_image, sigma):
    got = np.asarray(
        blur_u8(jnp.asarray(rgb_image), sigma, engine=Engine.PFFFT,
                size_mode="smooth235")
    )
    want = oracle.blur_u8_pffft(rgb_image, sigma)
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1
    assert (diff == 0).mean() > 0.98


def test_quirk_changes_nyquist_content_only(rng):
    # A Nyquist-heavy image (alternating columns) exposes the shortcut: the
    # quirk passes the Nyquist component through UNATTENUATED (kernel DC = 1)
    # where the true spectrum multiplies it down to ~0.
    h, w = 64, 64
    x = np.zeros((1, h, w), np.float32)
    x[..., ::2] = 200.0  # pure Nyquist along rows
    plan = make_plan((h, w), 3.0, size_mode="smooth235")

    quirk = oracle.blur_planar_pffft(x, plan)
    true = np.asarray(
        blur(jnp.asarray(x), 3.0, engine=Engine.FFT_TILES,
             size_mode="smooth235")
    )
    engine = np.asarray(
        blur(jnp.asarray(x), 3.0, engine=Engine.PFFFT, size_mode="smooth235")
    )
    # engine == its NumPy twin
    np.testing.assert_allclose(engine, quirk, atol=1e-2)
    # the quirk visibly preserves Nyquist energy the true multiply kills
    assert np.abs(quirk - true).max() > 10.0
    # interior of the quirked result still shows the alternation; the true
    # blur flattens it to the mean
    assert np.abs(np.diff(quirk[0, 32, 20:40])).max() > 10.0
    assert np.abs(np.diff(true[0, 32, 20:40])).max() < 1.0


def test_pffft_smooth_images_within_one_count(rgb_image):
    # On smooth content the shortcut is invisible (the reference's accuracy
    # claim): <=1 count of the flag-2 oracle when the data has no Nyquist
    # energy. Noisy content bounds at the noise's (small) Nyquist amplitude.
    h, w = 96, 80
    yy, xx = np.mgrid[0:h, 0:w]
    smooth = np.clip(
        127 + 80 * np.sin(xx / 7.0) + 60 * np.cos(yy / 11.0), 0, 255
    ).astype(np.uint8)[..., None].repeat(3, axis=-1)
    got = np.asarray(
        blur_u8(jnp.asarray(smooth), 10.0, engine=Engine.PFFFT,
                size_mode="smooth235")
    )
    want = oracle.blur_u8(smooth, 10.0, size_mode="smooth235")
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1

    noisy = np.asarray(
        blur_u8(jnp.asarray(rgb_image), 10.0, engine=Engine.PFFFT,
                size_mode="smooth235")
    )
    want_noisy = oracle.blur_u8(rgb_image, 10.0, size_mode="smooth235")
    assert np.abs(noisy.astype(int) - want_noisy.astype(int)).max() <= 5


def test_pffft_rejects_asymmetric_taps():
    from blur_algorithms import convolve_separable

    x = jnp.zeros((3, 32, 32), jnp.float32)
    with pytest.raises(ValueError, match="symmetric"):
        convolve_separable(
            x, [0.5, 0.25, 0.25, 0.0, 0.0], engine=Engine.PFFFT
        )


def test_cli_accepts_pffft_name(tmp_path, rgb_image):
    from blur_algorithms import cli
    from blur_algorithms.utils import io

    src = tmp_path / "in.ppm"
    io.write_image(str(src), rgb_image)
    out = tmp_path / "out.ppm"
    assert cli.main(["pffft", "4", str(src), "-o", str(out)]) == 0
    got = io.read_image(str(out))
    want = oracle.blur_u8_pffft(rgb_image, 4.0)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
