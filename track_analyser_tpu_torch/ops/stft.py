"""Framing and short-time Fourier transforms.

Conventions of the JAX reference (``track_analyser_tpu/ops/stft.py``),
which follows librosa 0.10: periodic hann window, centred frames, ZERO
padding. ``torch.stft`` is not used: with ``center=True`` it pads with
reflection, which changes the edge frames. Frames are an explicit
``unfold`` of the zero-padded signal, windowed, then ``torch.fft.rfft``
(cuFFT on the card), as on the reference's non-TPU branch.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["hann_window", "n_frames", "frame_signal", "stft", "magnitude", "fft_frequencies"]


@lru_cache(maxsize=32)
def hann_window(n: int) -> np.ndarray:
    """Periodic (DFT-even) hann window, the librosa/scipy default."""

    return (0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / n)).astype(np.float32)


def n_frames(n_samples: int, hop_length: int) -> int:
    """Frame count for a centred framing of ``n_samples``."""

    return 1 + n_samples // hop_length


def frame_signal(
    y: torch.Tensor,
    frame_length: int,
    hop_length: int,
    *,
    center: bool = True,
) -> torch.Tensor:
    """Frames of shape (..., n_frames, frame_length), a strided view of
    the zero-padded signal.

    With ``center=True`` the signal is zero-padded by frame_length//2 on
    both sides so frame t is centred at sample t*hop_length.
    """

    n = y.shape[-1]
    if center:
        pad = frame_length // 2
        total = 1 + n // hop_length
    else:
        pad = 0
        total = 1 + (n - frame_length) // hop_length
    # enough tail that the last frame is complete (zeros past the signal)
    tail = max(0, (total - 1) * hop_length + frame_length - pad - n)
    yp = F.pad(y, (pad, tail))
    return yp.unfold(-1, frame_length, hop_length)[..., :total, :]


def stft(y: torch.Tensor, n_fft: int, hop_length: int) -> torch.Tensor:
    """Complex STFT (hann window, centred frames) of shape
    (..., 1 + n_fft // 2, n_frames)."""

    win = torch.as_tensor(hann_window(n_fft), dtype=y.dtype, device=y.device)
    frames = frame_signal(y, n_fft, hop_length) * win
    spec = torch.fft.rfft(frames, n=n_fft, dim=-1)
    return spec.transpose(-1, -2)


def magnitude(y: torch.Tensor, n_fft: int, hop_length: int, power: float = 1.0) -> torch.Tensor:
    """|STFT|**power, contiguous in (..., bins, frames) layout."""

    s = torch.abs(stft(y, n_fft, hop_length)).contiguous()
    if power == 1.0:
        return s
    if power == 2.0:
        return s * s
    return s**power


def fft_frequencies(sr: int, n_fft: int) -> np.ndarray:
    return np.linspace(0.0, sr / 2.0, 1 + n_fft // 2, dtype=np.float64)
