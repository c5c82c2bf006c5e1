"""Per-channel smoothing recipes — the reference's color-cleanup workflow.

The reference's evaluation corpora (``test_images/Clean Up Comparisons``,
``test_images/Test 2``) compare blur recipes that smooth each channel of a
Lab / YCrCb image with a *different* sigma ("Smooth 5-5-7", "9-9-9",
"1-11-11") for color-transfer cleanup. This module makes that workflow a
first-class call: convert, blur channel c with sigma[c], convert back.

The three per-channel blurs run as ONE jit program per (shape, recipe) —
each channel's plan is applied inside the same traced function, so XLA
schedules the three pipelines together and the host sees a single dispatch
(round 1 compiled 3 programs and round-tripped planes through the host
between them). Color conversion stays on OpenCV when present (exactly what
the reference's author used); plain RGB recipes need no conversion and run
everywhere.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from blur_algorithms.api import Engine, _blur_planar, _resolve_engine
from blur_algorithms.ops.layout import round_to_u8
from blur_algorithms.ops.plan import make_plan

__all__ = ["channel_smooth"]

_CSPACES = ("rgb", "lab", "ycrcb")


@functools.lru_cache(maxsize=64)
def _compiled_recipe(
    h: int, w: int, sigmas: tuple, engine: Engine, size_mode: str
):
    """One jit program applying sigma[c] to channel c of f32 ``(3, H, W)``."""
    plans = []
    for sigma in sigmas:
        if sigma and float(sigma) > 0:
            plan = make_plan((h, w), float(sigma), size_mode=size_mode)
            plans.append((plan, _resolve_engine(engine, plan, in_bytes=4)))
        else:
            plans.append(None)

    def fn(work):
        planes = []
        for c, pe in enumerate(plans):
            plane = work[c]
            if pe is not None:
                plane = _blur_planar(plane, pe[0], pe[1])
            planes.append(plane)
        # round in-program (ops.layout semantics) so only uint8 crosses
        # the device boundary — 4x fewer bytes than shipping f32 planes
        return round_to_u8(jnp.stack(planes))

    return jax.jit(fn)


def channel_smooth(
    img_u8: np.ndarray,
    sigmas,
    colorspace: str = "rgb",
    engine: Engine | str = Engine.AUTO,
    size_mode: str = "auto",
) -> np.ndarray:
    """Blur each channel with its own sigma, optionally in Lab/YCrCb.

    ``img_u8``: (H, W, 3) uint8 RGB. ``sigmas``: one per channel; 0 or None
    leaves a channel untouched. Returns uint8 RGB.
    """
    img_u8 = np.asarray(img_u8)
    if img_u8.dtype != np.uint8 or img_u8.ndim != 3 or img_u8.shape[-1] != 3:
        raise ValueError("channel_smooth expects (H, W, 3) uint8 RGB")
    if colorspace not in _CSPACES:
        raise ValueError(f"colorspace must be one of {_CSPACES}")
    sigmas = tuple(float(s) if s else 0.0 for s in sigmas)
    if len(sigmas) != 3:
        raise ValueError("need exactly 3 sigmas")

    if colorspace == "rgb":
        work = img_u8.astype(np.float32)
    else:
        import cv2

        code = cv2.COLOR_RGB2Lab if colorspace == "lab" else cv2.COLOR_RGB2YCrCb
        work = cv2.cvtColor(img_u8, code).astype(np.float32)

    h, w = work.shape[:2]
    fn = _compiled_recipe(h, w, sigmas, Engine(engine), size_mode)
    out_u8 = np.moveaxis(
        np.asarray(fn(jnp.asarray(np.moveaxis(work, -1, 0)))), 0, -1
    )
    if colorspace == "rgb":
        return out_u8
    import cv2

    code = cv2.COLOR_Lab2RGB if colorspace == "lab" else cv2.COLOR_YCrCb2RGB
    return cv2.cvtColor(out_u8, code)
