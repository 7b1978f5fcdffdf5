"""Spectral summary features (LTAS, centroid, roll-off).

The JAX package's ``features.py``: all three features come from one
magnitude spectrogram on the caller's device, over the signal padded to
the fused graph's bucket (the LTAS mean is masked to the valid frames,
the per-frame curves are trimmed).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from .device import check_nans, resolve_device
from .ops.spectral import spectral_centroid, spectral_rolloff
from .ops.stft import fft_frequencies, magnitude
from .utils import AudioInput

__all__ = [
    "LongTermAverageSpectrum",
    "FeatureSeries",
    "FeatureAnalysis",
    "compute_ltas",
    "spectral_centroid_series",
    "spectral_rolloff_series",
    "analyse_features",
]


@dataclass(slots=True)
class LongTermAverageSpectrum:
    """Long-term average spectrum (LTAS) of a signal."""

    frequencies: np.ndarray
    magnitude: np.ndarray

    def as_dict(self) -> dict[str, Sequence[float]]:
        return {
            "frequencies": self.frequencies.tolist(),
            "magnitude": self.magnitude.tolist(),
        }


@dataclass(slots=True)
class FeatureSeries:
    """Container for frame-wise spectral features."""

    values: np.ndarray

    @property
    def mean(self) -> float:
        return float(np.mean(self.values)) if self.values.size else 0.0

    @property
    def median(self) -> float:
        return float(np.median(self.values)) if self.values.size else 0.0

    @property
    def as_list(self) -> list[float]:
        return self.values.tolist()


@dataclass(slots=True)
class FeatureAnalysis:
    """Aggregates the spectral feature outputs."""

    ltas: LongTermAverageSpectrum
    spectral_centroid: FeatureSeries
    spectral_rolloff: FeatureSeries


def _to_mono(samples: np.ndarray) -> np.ndarray:
    mono = np.asarray(samples, dtype=np.float32)
    if mono.ndim > 1:
        mono = np.mean(mono, axis=0)
    return mono


def _features_graph(
    y: torch.Tensor, n_valid: int, *, sr: int, n_fft: int, hop_length: int, roll_percent: float
) -> tuple:
    """(LTAS masked to the valid frames, centroid, rolloff) of the padded
    signal ``y``."""

    mag = magnitude(y, n_fft, hop_length, power=1.0)
    freqs = fft_frequencies(sr, n_fft)
    fmask = torch.arange(mag.shape[-1], device=y.device) < 1 + n_valid // hop_length
    zero = torch.zeros((), dtype=mag.dtype, device=y.device)
    ltas = torch.where(fmask, mag, zero).sum(dim=-1) / torch.clamp_min(fmask.sum(), 1)
    return ltas, spectral_centroid(mag, freqs), spectral_rolloff(mag, freqs, roll_percent)


def _run(samples, sr: int, n_fft: int, hop_length: int, roll_percent: float = 0.85, *, device="cuda"):
    """One device pass -> (ltas, centroid, rolloff) as float64 numpy."""

    from .substrate import pad_to_bucket

    dev = resolve_device(device)
    mono = _to_mono(samples)
    n = mono.size
    padded, f_valid = pad_to_bucket(mono, hop=hop_length)
    with torch.inference_mode():
        ltas, centroid, rolloff = check_nans(
            "features._features_graph",
            _features_graph(
                torch.from_numpy(padded).to(dev), n,
                sr=sr, n_fft=n_fft, hop_length=hop_length, roll_percent=float(roll_percent),
            ),
        )
        return (
            ltas.cpu().numpy().astype(np.float64),
            centroid.cpu().numpy().astype(np.float64)[:f_valid],
            rolloff.cpu().numpy().astype(np.float64)[:f_valid],
        )


def compute_ltas(
    samples: np.ndarray,
    sample_rate: int,
    *,
    n_fft: int = 2_048,
    hop_length: int = 512,
    window: str = "hann",
    device="cuda",
) -> LongTermAverageSpectrum:
    """Compute the long-term average spectrum for ``samples``."""

    del window  # hann is the only window; kept for signature parity
    ltas_mag, _, _ = _run(samples, sample_rate, n_fft, hop_length, device=device)
    return LongTermAverageSpectrum(
        frequencies=fft_frequencies(sample_rate, n_fft), magnitude=ltas_mag
    )


def spectral_centroid_series(
    samples: np.ndarray,
    sample_rate: int,
    *,
    n_fft: int = 2_048,
    hop_length: int = 512,
    device="cuda",
) -> FeatureSeries:
    """Return the spectral centroid trajectory for ``samples``."""

    return FeatureSeries(values=_run(samples, sample_rate, n_fft, hop_length, device=device)[1])


def spectral_rolloff_series(
    samples: np.ndarray,
    sample_rate: int,
    *,
    roll_percent: float = 0.85,
    n_fft: int = 2_048,
    hop_length: int = 512,
    device="cuda",
) -> FeatureSeries:
    """Return the spectral roll-off trajectory for ``samples``."""

    return FeatureSeries(
        values=_run(samples, sample_rate, n_fft, hop_length, roll_percent, device=device)[2]
    )


def analyse_features(
    audio: AudioInput,
    *,
    n_fft: int = 2_048,
    hop_length: int = 512,
    roll_percent: float = 0.85,
    device="cuda",
) -> FeatureAnalysis:
    """Derive spectral summary features for ``audio`` in one device pass."""

    ltas_mag, centroid, rolloff = _run(
        audio.samples, audio.sample_rate, n_fft, hop_length, roll_percent, device=device
    )
    return FeatureAnalysis(
        ltas=LongTermAverageSpectrum(
            frequencies=fft_frequencies(audio.sample_rate, n_fft), magnitude=ltas_mag
        ),
        spectral_centroid=FeatureSeries(values=centroid),
        spectral_rolloff=FeatureSeries(values=rolloff),
    )
