"""Frame-wise spectral summary features, the long-term average spectrum
and the spectral-balance weights."""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

__all__ = ["ltas", "spectral_centroid", "spectral_rolloff", "balance_band_weights"]


@lru_cache(maxsize=8)
def balance_band_weights(
    sr: int, n_fft: int, edges: tuple = (200.0, 2000.0)
) -> np.ndarray:
    """(3, 1+n_fft/2) fractional band weights for the low/mid/high
    spectral-balance split: the bin straddling each edge is split
    fractionally between its neighbouring bands. Each bin's three weights
    sum to 1."""

    res = sr / n_fft
    freqs = np.linspace(0.0, sr / 2.0, 1 + n_fft // 2)
    lo_edge = freqs - res / 2.0
    hi_edge = freqs + res / 2.0
    bands = [(0.0, edges[0]), (edges[0], edges[1]), (edges[1], sr / 2.0 + res)]
    w = np.zeros((3, freqs.size), dtype=np.float64)
    for i, (lo, hi) in enumerate(bands):
        overlap = np.minimum(hi, hi_edge) - np.maximum(lo, lo_edge)
        w[i] = np.clip(overlap, 0.0, None)
    w /= np.maximum(w.sum(axis=0, keepdims=True), 1e-12)
    return w.astype(np.float32)


def ltas(mag: torch.Tensor) -> torch.Tensor:
    """Long-term average spectrum: mean |STFT| per bin. Input (..., freq, time)."""

    return mag.mean(dim=-1)


def spectral_centroid(mag: torch.Tensor, freqs: np.ndarray) -> torch.Tensor:
    """Magnitude-weighted mean frequency per frame. Input (..., freq, time)."""

    f = torch.as_tensor(freqs, dtype=torch.float32, device=mag.device)[:, None]
    total = mag.sum(dim=-2, keepdim=True)
    norm = mag / torch.where(total > 0, total, torch.ones_like(total))
    return (f * norm).sum(dim=-2)


def spectral_rolloff(
    mag: torch.Tensor, freqs: np.ndarray, roll_percent: float = 0.85
) -> torch.Tensor:
    """Frequency below which ``roll_percent`` of the energy sits, per frame."""

    f = torch.as_tensor(freqs, dtype=torch.float32, device=mag.device)[:, None]
    total = torch.cumsum(mag, dim=-2)
    threshold = roll_percent * total[..., -1:, :]
    passed = total >= threshold
    candidate = torch.where(passed, f, torch.full_like(f, float("inf")))
    out = candidate.min(dim=-2).values
    return torch.where(torch.isfinite(out), out, torch.zeros_like(out))
