"""Mel / MFCC primitives.

Filterbanks are numpy constructors (cached per (sr, n_fft)), the same
arithmetic as the JAX reference's ``ops/mel.py`` so the constants are
bit-identical; the tensor work is one filterbank matmul per spectrogram.
The mel scale is Slaney-style (linear below 1 kHz, log above).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..device import device_constant

__all__ = [
    "hz_to_mel",
    "mel_to_hz",
    "mel_filterbank",
    "dct_matrix",
    "power_to_db",
    "amplitude_to_db",
    "melspectrogram_from_power",
    "mfcc_from_log_mel",
]

_F_SP = 200.0 / 3.0
_MIN_LOG_HZ = 1_000.0
_MIN_LOG_MEL = _MIN_LOG_HZ / _F_SP
_LOGSTEP = np.log(6.4) / 27.0


def hz_to_mel(frequencies: np.ndarray) -> np.ndarray:
    f = np.asarray(frequencies, dtype=np.float64)
    mels = f / _F_SP
    log_region = f >= _MIN_LOG_HZ
    mels = np.where(
        log_region,
        _MIN_LOG_MEL + np.log(np.maximum(f, _MIN_LOG_HZ) / _MIN_LOG_HZ) / _LOGSTEP,
        mels,
    )
    return mels


def mel_to_hz(mels: np.ndarray) -> np.ndarray:
    m = np.asarray(mels, dtype=np.float64)
    freqs = m * _F_SP
    log_region = m >= _MIN_LOG_MEL
    freqs = np.where(
        log_region, _MIN_LOG_HZ * np.exp(_LOGSTEP * (m - _MIN_LOG_MEL)), freqs
    )
    return freqs


@lru_cache(maxsize=32)
def mel_filterbank(
    sr: int, n_fft: int, n_mels: int = 128, fmin: float = 0.0, fmax: float | None = None
) -> np.ndarray:
    """Slaney-normalised triangular mel filterbank, shape (n_mels, 1+n_fft/2)."""

    if fmax is None:
        fmax = sr / 2.0
    fft_freqs = np.linspace(0.0, sr / 2.0, 1 + n_fft // 2)
    mel_pts = mel_to_hz(np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2))

    fdiff = np.diff(mel_pts)
    ramps = mel_pts[:, None] - fft_freqs[None, :]

    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))

    # Slaney-style area normalisation
    enorm = 2.0 / (mel_pts[2 : n_mels + 2] - mel_pts[:n_mels])
    weights *= enorm[:, None]
    return weights.astype(np.float32)


@lru_cache(maxsize=8)
def dct_matrix(n_out: int, n_in: int) -> np.ndarray:
    """Orthonormal DCT-II matrix of shape (n_out, n_in)."""

    k = np.arange(n_out)[:, None]
    n = np.arange(n_in)[None, :]
    mat = np.cos(np.pi * k * (2 * n + 1) / (2.0 * n_in)) * np.sqrt(2.0 / n_in)
    mat[0] /= np.sqrt(2.0)
    return mat.astype(np.float32)


def power_to_db(
    s: torch.Tensor,
    *,
    ref: float = 1.0,
    amin: float = 1e-10,
    top_db: float | None = 80.0,
    dims: "tuple[int, ...] | None" = None,
) -> torch.Tensor:
    """10*log10(S/ref) with floor clipping (librosa convention).

    The ``top_db`` floor sits below the maximum over ``dims`` (every axis
    when None); a batch of lanes passes its per-lane axes, e.g. (-2, -1)
    for (B, bands, frames), so that each lane keeps its own floor."""

    log_spec = 10.0 * torch.log10(torch.clamp_min(s, amin))
    ref_t = torch.full((), max(amin, ref), dtype=s.dtype, device=s.device)
    log_spec = log_spec - 10.0 * torch.log10(ref_t)
    if top_db is not None:
        peak = log_spec.max() if dims is None else torch.amax(log_spec, dim=dims, keepdim=True)
        log_spec = torch.maximum(log_spec, peak - top_db)
    return log_spec


def amplitude_to_db(
    s: torch.Tensor,
    *,
    ref: float = 1.0,
    amin: float = 1e-5,
    top_db: float | None = None,
    dims: "tuple[int, ...] | None" = None,
) -> torch.Tensor:
    return power_to_db(s**2, ref=ref**2, amin=amin**2, top_db=top_db, dims=dims)


def melspectrogram_from_power(power_spec: torch.Tensor, fb: "np.ndarray | torch.Tensor") -> torch.Tensor:
    """Project a power spectrogram (..., freq, time) through the mel
    filterbank (a tensor on the spectrogram's device, such as a
    ``device_constant``, is used as it is)."""

    return torch.as_tensor(fb, device=power_spec.device) @ power_spec


def mfcc_from_log_mel(log_mel: torch.Tensor, n_mfcc: int = 13) -> torch.Tensor:
    """MFCCs via an orthonormal DCT-II matmul; input (..., n_mels, time)."""

    mat = device_constant(dct_matrix, n_mfcc, log_mel.shape[-2], device=log_mel.device)
    return mat @ log_mel
