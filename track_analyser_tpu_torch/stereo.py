"""Stereo image analysis (mid/side, correlation, frequency-dependent width).

The JAX package's ``stereo.py``: the same dataclasses, helpers and band
semantics. The time-domain mid/side RMS and the per-band widths come
from graphs on the caller's device over the pair padded to the fused
graph's bucket; the centered correlation is float64 on the host, as
there (duplicated mono must read 1.0 within 1e-6, which float32
accumulation over a long signal cannot hold).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from .device import check_nans, resolve_device
from .ops.stft import fft_frequencies, stft
from .utils import AudioInput

_EPS = 1e-12

__all__ = [
    "StereoWidthBands",
    "StereoAnalysis",
    "mid_side_rms",
    "mono_compatibility_correlation",
    "frequency_dependent_width",
    "analyse_stereo",
]

# Default band plan: (name, low Hz, high Hz); the high band runs to
# Nyquist at call time.
_DEFAULT_BANDS = (("low", 0.0, 200.0), ("mid", 200.0, 2_000.0), ("high", 2_000.0, None))


@dataclass(slots=True)
class StereoWidthBands:
    """Frequency dependent stereo width estimates."""

    low: float
    mid: float
    high: float

    def as_dict(self) -> dict[str, float]:
        return {"low": self.low, "mid": self.mid, "high": self.high}


@dataclass(slots=True)
class StereoAnalysis:
    """Aggregate container for stereo image metrics."""

    mid_rms: float
    side_rms: float
    correlation: float
    width: StereoWidthBands


def _as_two_channels(data: np.ndarray) -> np.ndarray:
    """Normalise any layout to (2, n): mono duplicates, frame-major
    transposes, extra channels drop."""

    arr = np.asarray(data, dtype=np.float32)
    if arr.ndim == 1:
        return np.stack([arr, arr])
    if arr.shape[0] == 2:
        return arr
    if arr.shape[1] == 2:
        return np.ascontiguousarray(arr.T)
    if arr.shape[0] == 1:
        return np.concatenate([arr, arr], axis=0)
    return arr[:2]


def _ensure_stereo_array(audio: AudioInput) -> np.ndarray:
    source = audio.stereo_samples if audio.stereo_samples is not None else audio.samples
    return _as_two_channels(source)


# ---------------------------------------------------------------------------
# Device graphs
# ---------------------------------------------------------------------------


def _ms_graph(stereo: torch.Tensor, n_valid: int) -> torch.Tensor:
    """[mid RMS, side RMS] over the first ``n_valid`` samples of the
    padded pair (2, n)."""

    left, right = stereo[0], stereo[1]
    mid = 0.5 * (left + right)
    side = 0.5 * (left - right)
    zero = torch.zeros((), dtype=stereo.dtype, device=stereo.device)
    smask = torch.arange(left.shape[-1], device=stereo.device) < n_valid
    count = max(n_valid, 1)
    mid_rms = torch.sqrt(torch.where(smask, mid * mid, zero).sum() / count)
    side_rms = torch.sqrt(torch.where(smask, side * side, zero).sum() / count)
    return torch.stack([mid_rms, side_rms])


def _width_graph(
    stereo: torch.Tensor, n_valid: int, *, sr: int, n_fft: int, hop_length: int, band_edges
) -> torch.Tensor:
    """Per-band sqrt(side / mid energy) from the M/S spectrograms, all
    bands in one pass; the padding frames are masked out."""

    spec = stft(stereo, n_fft, hop_length)  # (2, bins, T)
    spec_l, spec_r = spec[0], spec[1]
    dev = stereo.device
    zero = torch.zeros((), dtype=stereo.dtype, device=dev)
    f_valid = 1 + n_valid // hop_length
    fmask = (torch.arange(spec_l.shape[-1], device=dev) < f_valid)[None, :]
    mid_e = torch.where(fmask, torch.abs(0.5 * (spec_l + spec_r)) ** 2, zero)
    side_e = torch.where(fmask, torch.abs(0.5 * (spec_l - spec_r)) ** 2, zero)
    freqs = torch.as_tensor(fft_frequencies(sr, n_fft), dtype=torch.float32, device=dev)
    frames = max(f_valid, 1)

    widths = []
    for low, high in band_edges:
        mask = ((freqs >= low) & (freqs <= high))[:, None]
        count = torch.clamp_min(mask.sum(), 1) * frames
        m = torch.where(mask, mid_e, zero).sum() / count
        s = torch.where(mask, side_e, zero).sum() / count
        quiet = m <= _EPS
        widths.append(torch.where(quiet, zero, torch.sqrt(s / torch.where(quiet, torch.ones_like(m), m))))
    return torch.stack(widths)


# ---------------------------------------------------------------------------
# Public helpers
# ---------------------------------------------------------------------------


def _bucket_pad_pair(pair: np.ndarray) -> tuple[np.ndarray, int]:
    """Zero-pad (2, n) to the fused graph's bucket."""

    from .substrate import pad_to_bucket

    padded, _ = pad_to_bucket(pair)
    return padded, pair.shape[-1]


def _mid_side(pair: np.ndarray, device) -> tuple[float, float]:
    dev = resolve_device(device)
    padded, n = _bucket_pad_pair(pair)
    with torch.inference_mode():
        mid, side = check_nans("stereo._ms_graph", _ms_graph(torch.from_numpy(padded).to(dev), n)).cpu().numpy()
    return float(mid), float(side)


def mid_side_rms(stereo: np.ndarray, *, device="cuda") -> tuple[float, float]:
    pair = _as_two_channels(stereo)
    if pair.shape[-1] == 0:
        return 0.0, 0.0
    return _mid_side(pair, device)


def mono_compatibility_correlation(stereo: np.ndarray) -> float:
    """Centered L/R correlation in float64 on the host; degenerate
    channels report 1.0."""

    pair = _as_two_channels(stereo).astype(np.float64)
    if pair.shape[-1] == 0:
        return 1.0
    centered = pair - pair.mean(axis=1, keepdims=True)
    denom = float(np.sqrt((centered[0] ** 2).sum() * (centered[1] ** 2).sum()))
    if denom <= _EPS:
        return 1.0
    return float(np.clip(centered[0] @ centered[1] / denom, -1.0, 1.0))


def frequency_dependent_width(
    stereo: np.ndarray,
    sample_rate: int,
    *,
    bands: Sequence[tuple[str, float, float]] | None = None,
    n_fft: int = 2_048,
    hop_length: int = 512,
    device="cuda",
) -> StereoWidthBands:
    """Per-band sqrt(side-energy / mid-energy) from M/S spectrograms."""

    pair = _as_two_channels(stereo)
    nyquist = sample_rate / 2.0
    if bands is None:
        bands = [
            (name, lo, min(hi, nyquist) if hi is not None else nyquist)
            for name, lo, hi in _DEFAULT_BANDS
        ]
    edges = tuple((float(lo), float(hi)) for _, lo, hi in bands)

    dev = resolve_device(device)
    padded, n = _bucket_pad_pair(pair)
    with torch.inference_mode():
        widths = _width_graph(
            torch.from_numpy(padded).to(dev), n, sr=sample_rate, n_fft=n_fft,
            hop_length=hop_length, band_edges=edges,
        )
        widths = check_nans("stereo._width_graph", widths).cpu().numpy().astype(np.float64)
    # Bands containing no FFT bin report width 0.
    freqs = fft_frequencies(sample_rate, n_fft)
    by_name = {
        name: float(w) if np.any((freqs >= lo) & (freqs <= hi)) else 0.0
        for (name, _, _), (lo, hi), w in zip(bands, edges, widths)
    }
    return StereoWidthBands(
        low=by_name.get("low", 0.0),
        mid=by_name.get("mid", 0.0),
        high=by_name.get("high", 0.0),
    )


def analyse_stereo(
    audio: AudioInput,
    *,
    n_fft: int = 2_048,
    hop_length: int = 512,
    bands: Sequence[tuple[str, float, float]] | None = None,
    device="cuda",
) -> StereoAnalysis:
    pair = _ensure_stereo_array(audio)
    mid, side = _mid_side(pair, device)
    return StereoAnalysis(
        mid_rms=mid,
        side_rms=side,
        correlation=mono_compatibility_correlation(pair),
        width=frequency_dependent_width(
            pair, audio.sample_rate, bands=bands, n_fft=n_fft, hop_length=hop_length,
            device=device,
        ),
    )
