"""blur_algorithms — an image-blur framework in JAX (XLA and Pallas).

A ground-up re-design of the capabilities of
``michelerenzullo/Blur_algorithms`` (Fast Fourier Convolution image
processing; reference layout documented in ``SURVEY.md``):

* true Gaussian blur via FFT convolution (reference ``Source.cpp:143-570``)
  — here: batched XLA rFFTs + fused spectral multiply in a single jit;
* direct separable convolution engine (mathematically identical to the
  truncated-kernel FFT convolution, as banded matmuls on the tensor
  cores — a fused Pallas kernel on NVIDIA GPUs);
* fast box blur via sliding accumulator (reference ``FastBoxBlur`` submodule,
  ``Source.cpp:587``) — here: a cumulative-sum difference scan;
* reflect-101 border padding with clamped pads (``Utils.hpp:212-243``);
* planar deinterleave/interleave with exact +0.5 uint8 rounding
  (``Utils.hpp:159-210``);
* FFT-size planning ({2,3,5}-smooth / power-of-two) (``Utils.hpp:141-157``);
* DFT log-magnitude spectrum export (``Source.cpp:240-252``).

Every per-row / per-channel CPU thread loop of the reference becomes a batch
dimension of one compiled XLA dispatch; multi-device scaling is expressed with
``jax.sharding`` meshes (data-parallel over frames + spatial row sharding
with halo exchange), not threads.
"""

from blur_algorithms.api import (
    blur,
    blur_u8,
    gaussian_blur,
    box_blur,
    convolve_separable,
    dft_spectrum,
    Engine,
)
from blur_algorithms.ops.multi_sigma import (
    blur_multi_sigma,
    blur_multi_sigma_u8,
)
from blur_algorithms.ops.plan import BlurPlan, make_custom_plan, make_plan

__version__ = "0.6.0"

__all__ = [
    "blur",
    "blur_u8",
    "gaussian_blur",
    "box_blur",
    "convolve_separable",
    "dft_spectrum",
    "blur_multi_sigma",
    "blur_multi_sigma_u8",
    "Engine",
    "BlurPlan",
    "make_custom_plan",
    "make_plan",
    "__version__",
]
