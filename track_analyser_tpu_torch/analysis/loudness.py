"""Loudness and dynamics analysis (EBU R128) on the caller's device.

The JAX package's ``analysis/loudness.py``: ``LoudnessAnalysis``,
``measure_loudness`` (gated integrated loudness, short-term and
momentary RMS curves, loudness range), ``true_peak_dbtp`` (the x8
polyphase upsampler) and ``analyse_loudness``. Each graph runs over the
signal padded to the fused graph's bucket; the gating masks the padding
and the curves are trimmed to the valid frames.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np
import torch

from ..config import DEFAULT_CONFIG
from ..device import check_nans, resolve_device
from ..ops.loudness import integrated_lufs, rms_db_curve
from ..ops.resample import oversampled_peak
from ..utils import AudioInput, seed_everything

__all__ = ["LoudnessAnalysis", "measure_loudness", "true_peak_dbtp", "analyse_loudness"]


@dataclass(slots=True)
class LoudnessAnalysis:
    integrated_lufs: float
    short_term_lufs: List[float]
    momentary_lufs: List[float]
    loudness_range: float
    true_peak_dbfs: float
    rms_dbfs: float


def _window_params(sample_rate: int, meter_block_size: float) -> Tuple[int, int]:
    frame_length = max(1024, int(round(sample_rate * meter_block_size)))
    if frame_length % 2:
        frame_length += 1
    hop_length = max(1, frame_length // 2)
    return frame_length, hop_length


def _bucket_pad(samples: np.ndarray) -> tuple[np.ndarray, int]:
    """Zero-pad to the fused graph's bucket; every graph below masks or
    trims the padding."""

    from ..substrate import pad_to_bucket

    padded, _ = pad_to_bucket(samples)
    return padded, samples.size


def _windowed_loudness(
    samples: np.ndarray, sample_rate: int, meter_block_size: float, device
) -> np.ndarray:
    """Sliding-window RMS loudness in dB."""

    frame_length, hop_length = _window_params(sample_rate, meter_block_size)
    padded, n = _bucket_pad(samples)
    with torch.inference_mode():
        out = check_nans("ops.loudness.rms_db_curve", rms_db_curve(torch.from_numpy(padded).to(device), frame_length, hop_length))
    return out.cpu().numpy().astype(np.float64)[: 1 + n // hop_length]


def _integrated_graph(y: torch.Tensor, n_valid: int, *, sample_rate: int, block: float) -> torch.Tensor:
    return integrated_lufs(
        y,
        sample_rate,
        block_seconds=block,
        absolute_gate=DEFAULT_CONFIG.gate_absolute_lufs,
        relative_gate_lu=DEFAULT_CONFIG.gate_relative_lu,
        n_valid=n_valid,
    )


def measure_loudness(
    samples: np.ndarray,
    sample_rate: int,
    meter_block_size: float = 0.400,
    *,
    device="cuda",
) -> Tuple[float, List[float], List[float], float]:
    """(integrated LUFS, short-term curve, momentary curve, loudness
    range) of mono ``samples``."""

    samples = np.asarray(samples, dtype=np.float32)
    if samples.ndim != 1:
        raise ValueError("measure_loudness expects mono audio samples")
    dev = resolve_device(device)

    short_term = _windowed_loudness(samples, sample_rate, 3.0, dev)
    momentary = _windowed_loudness(samples, sample_rate, meter_block_size, dev)

    padded, n = _bucket_pad(samples)
    with torch.inference_mode():
        integrated = float(
            check_nans(
                "analysis.loudness._integrated_graph",
                _integrated_graph(
                    torch.from_numpy(padded).to(dev), n,
                    sample_rate=sample_rate, block=float(meter_block_size),
                ),
            )
        )
    # Loudness range as the momentary distribution's 5-95 percentile spread.
    lra = float(np.percentile(momentary, 95) - np.percentile(momentary, 5))

    return (
        integrated,
        np.asarray(short_term, dtype=float).tolist(),
        np.asarray(momentary, dtype=float).tolist(),
        lra,
    )


def true_peak_dbtp(
    samples: np.ndarray, sample_rate: int, *, oversample: int = 8, device="cuda"
) -> float:
    """dB true peak via polyphase oversampling."""

    if oversample < 1:
        raise ValueError("oversample must be >= 1")
    samples = np.asarray(samples, dtype=np.float32)
    if samples.ndim != 1:
        raise ValueError("true_peak_dbtp expects mono audio samples")

    if oversample == 1:
        peak = float(np.max(np.abs(samples))) if samples.size else 0.0
    else:
        # zeros cannot raise the peak: the bucket padding is transparent
        dev = resolve_device(device)
        padded, _n = _bucket_pad(samples)
        with torch.inference_mode():
            peak = float(
                check_nans("ops.resample.oversampled_peak", oversampled_peak(torch.from_numpy(padded).to(dev), oversample))
            )
    return float(20.0 * np.log10(peak + 1e-12))


def analyse_loudness(
    audio: AudioInput,
    *,
    seed: int,
    meter_block_size: float = 0.400,
    device="cuda",
) -> LoudnessAnalysis:
    """Compute LUFS, loudness range and peak information on ``device``."""

    if not isinstance(audio, AudioInput):
        raise TypeError("analyse_loudness expects an AudioInput instance")
    seed_everything(seed)

    samples = audio.samples.astype(np.float32)

    integrated, short_term, momentary, loudness_range = measure_loudness(
        samples, audio.sample_rate, meter_block_size, device=device
    )
    true_peak_dbfs = true_peak_dbtp(samples, audio.sample_rate, device=device)
    rms_val = float(np.sqrt(np.mean(samples**2))) if samples.size else 0.0
    rms_dbfs = float(20.0 * np.log10(rms_val + 1e-12))

    return LoudnessAnalysis(
        integrated_lufs=integrated,
        short_term_lufs=short_term,
        momentary_lufs=momentary,
        loudness_range=loudness_range,
        true_peak_dbfs=true_peak_dbfs,
        rms_dbfs=rms_dbfs,
    )
