"""Device-mesh construction helpers."""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh

__all__ = ["make_mesh"]


def make_mesh(
    dp: int | None = None,
    sp: int = 1,
    devices: list | None = None,
) -> Mesh:
    """Build a ``(dp, sp)`` mesh: frames over ``dp``, image rows over ``sp``.

    With ``dp=None`` all remaining devices go to ``dp``. Each frame is
    independent so ``dp`` needs zero communication and ``sp`` only
    nearest-neighbor halo exchange.
    """
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if dp is None:
        if n % sp:
            raise ValueError(f"{n} devices not divisible by sp={sp}")
        dp = n // sp
    if dp * sp != n:
        raise ValueError(f"dp*sp = {dp}*{sp} != {n} devices")
    arr = np.asarray(devices).reshape(dp, sp)
    return Mesh(arr, axis_names=("dp", "sp"))
