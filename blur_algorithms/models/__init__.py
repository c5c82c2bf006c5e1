"""Configured blur pipelines (the framework's "model" objects)."""

from blur_algorithms.models.channel_smooth import channel_smooth
from blur_algorithms.models.deconvolve import wiener_deconvolve
from blur_algorithms.models.filters import high_pass, unsharp_mask
from blur_algorithms.models.pipeline import (
    BlurPipeline,
    GaussianBlur,
    FastBoxBlur,
    SpectrumAnalyzer,
)

__all__ = [
    "BlurPipeline",
    "GaussianBlur",
    "FastBoxBlur",
    "SpectrumAnalyzer",
    "channel_smooth",
    "wiener_deconvolve",
    "unsharp_mask",
    "high_pass",
]
