"""Ops tier: DSP primitives on PyTorch tensors (plain PyTorch, plus the
hand-written CUDA kernels behind ``median.median31`` and
``fused_stft.stft_magnitude``, built by ``cuda_build``)."""

from . import (
    chroma,
    cuda_build,
    filters,
    fused_stft,
    loudness,
    median,
    mel,
    onset,
    peaks,
    resample,
    spectral,
    stft,
)

__all__ = [
    "chroma",
    "cuda_build",
    "filters",
    "fused_stft",
    "loudness",
    "median",
    "mel",
    "onset",
    "peaks",
    "resample",
    "spectral",
    "stft",
]
