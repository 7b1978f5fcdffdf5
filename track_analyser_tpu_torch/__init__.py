"""track_analyser_tpu_torch: the audio track analyser in PyTorch + CUDA.

A port of ``track_analyser_tpu`` (JAX on a TPU, kept beside it as the
reference) to PyTorch on an NVIDIA H100. The first slice is the default
path, ``analyse_track(path)``: the fused one-pass analysis of one track
plus the host finishers, producing the same ``TrackAnalysisResult``.
HPSS's two sliding medians run through a hand-written CUDA kernel
(``csrc/median31.cu``); everything else is plain PyTorch.

This package imports torch, numpy and scipy, never jax.
"""

from __future__ import annotations

from .pipeline import TrackAnalysisResult, analyse_track
from .utils import AudioInput

__all__ = ["analyse_track", "TrackAnalysisResult", "AudioInput"]
