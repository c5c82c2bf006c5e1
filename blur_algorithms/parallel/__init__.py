"""Multi-device scaling: device meshes, sharded blur with halo exchange.

The reference's parallelism is single-process threads over rows/channels
(``hybrid_loop``, ``Utils.hpp:16-55``); SURVEY.md §2 maps that to batch
dimensions of one XLA dispatch. This package adds what the reference never
had: scaling across devices — data parallelism over frames (``dp``) and
spatial row sharding within a frame (``sp``) with reflect-aware halo
exchange (``jax.lax.ppermute``), expressed with
``jax.sharding.Mesh`` + ``shard_map``.
"""

from blur_algorithms.parallel.mesh import make_mesh
from blur_algorithms.parallel.sharded import (
    blur_fft_sharded,
    blur_fft_sharded_u8,
    blur_sharded,
    blur_sharded_u8,
)

__all__ = [
    "make_mesh",
    "blur_sharded",
    "blur_sharded_u8",
    "blur_fft_sharded",
    "blur_fft_sharded_u8",
]
