"""track_analyser_tpu_torch: the audio track analyser in PyTorch + CUDA.

A port of ``track_analyser_tpu`` (JAX on a TPU, kept beside it as the
reference) to PyTorch on an NVIDIA H100. Ported so far: the default
path, ``analyse_track(path)`` (the fused one-pass analysis of one track
plus the host finishers, producing the same ``TrackAnalysisResult``),
and the library sweep ``parallel.batch.analyse_library``, both through
one fused graph with a leading batch axis, with the float32, int16, int8
and "ms" transports; stem separation (``use_stems=True``: the band-split
mask net blended with the DSP separator) and artefact rendering
(``output_dir``: report.json, CSVs, HTML, MIDI, plots); the per-module
path (``fused=False``), the ``ms6``/``ms5`` transports and the CLI; the
decode ladder (WAV/AIFF, FLAC, Ogg, MP3, ffmpeg) and the native host
library (``native/``: WAV/FLAC decode and the transport quantisers, C++
built at first use); ``profiling`` and the
``TRACK_ANALYSER_TPU_DEBUG_NANS=1`` sanitizer. HPSS's two sliding
medians run through a hand-written CUDA kernel (``csrc/median31.cu``),
and the fused |STFT| through another (``csrc/stft_mag.cu``, when
``TA_PALLAS_STFT=1``); everything else on the device is plain PyTorch.

This package imports torch, numpy and scipy, never jax.
"""

from __future__ import annotations

from importlib.metadata import PackageNotFoundError, version

from .pipeline import TrackAnalysisResult, analyse_track
from .utils import AudioInput

__all__ = ["analyse_track", "TrackAnalysisResult", "AudioInput", "get_version"]


def get_version() -> str:
    """Version of the installed distribution that ships this package and
    the JAX one (``track-analyser-tpu``); "0.0.0" from a source checkout."""

    try:
        return version("track-analyser-tpu")
    except PackageNotFoundError:
        return "0.0.0"
