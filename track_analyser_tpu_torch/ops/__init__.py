"""Ops tier: DSP primitives on PyTorch tensors (plain PyTorch, plus the
hand-written CUDA median kernel behind ``median.median31``)."""

from . import chroma, filters, loudness, median, mel, onset, peaks, resample, spectral, stft

__all__ = [
    "chroma",
    "filters",
    "loudness",
    "median",
    "mel",
    "onset",
    "peaks",
    "resample",
    "spectral",
    "stft",
]
