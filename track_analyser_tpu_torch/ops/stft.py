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

__all__ = ["hann_window", "n_frames", "frame_signal", "stft", "magnitude", "fft_frequencies", "istft"]


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


def _overlap_add(frames: torch.Tensor, hop_length: int) -> torch.Tensor:
    """Overlap-add of (..., T, n_fft) frames placed ``hop_length`` apart:
    (..., T * hop_length + n_fft).

    With n_fft a multiple of the hop (every framing in this package) frame
    t is n_fft // hop slabs of hop samples that land on rows t, t + 1, ...
    of the (rows, hop) output: one shifted add per slab index, in a fixed
    order (the reference's scatter-add order: earlier frames first), with
    no atomics. ``index_add_`` on CUDA adds in no fixed order, so two runs
    would differ in the last bit; it serves only the general case."""

    total, n_fft = frames.shape[-2:]
    lead = frames.shape[:-2]
    if n_fft % hop_length == 0:
        k = n_fft // hop_length
        slabs = frames.reshape(lead + (total, k, hop_length))
        out = frames.new_zeros(lead + (total + k, hop_length))
        for j in reversed(range(k)):
            out[..., j : j + total, :] += slabs[..., j, :]
        return out.reshape(lead + ((total + k) * hop_length,))
    starts = torch.arange(total, device=frames.device) * hop_length
    idx = (starts[:, None] + torch.arange(n_fft, device=frames.device)[None, :]).reshape(-1)
    out = frames.new_zeros(lead + (total * hop_length + n_fft,))
    return out.index_add_(-1, idx, frames.reshape(lead + (-1,)))


def istft(
    spec: torch.Tensor,
    n_fft: int,
    hop_length: int,
    n_samples: int,
    *,
    f_valid: "torch.Tensor | int | None" = None,
) -> torch.Tensor:
    """Inverse of :func:`stft` (hann window, centred frames) back to
    ``n_samples`` samples: windowed overlap-add over the squared-window
    sum. ``spec`` is (..., 1 + n_fft // 2, n_frames) complex; the leading
    axes are a batch.

    ``f_valid`` (optional): number of valid frames. Frames at or beyond it
    are left out of BOTH the overlap-add and the window-sum normaliser, so
    a bucket-padded spectrogram inverts to exactly the samples an
    exact-shape spectrogram would (the padding frames' windows would
    otherwise inflate the normaliser near the tail).
    """

    win = torch.as_tensor(hann_window(n_fft), device=spec.device)
    # A real signal's DC and Nyquist bins are real, and a real inverse
    # transform cannot represent their imaginary parts: the reference's
    # (and the host's) irfft ignores them. cuFFT's C2R does not on every
    # plan (at 5 000 frames it read a masked spectrogram's imaginary DC into
    # the signal, 1.6e-2 off the host), so they are cleared here, in a copy
    # this function owns.
    by_frame = spec.transpose(-1, -2).clone(memory_format=torch.contiguous_format)
    by_frame.imag[..., 0] = 0.0
    by_frame.imag[..., n_fft // 2] = 0.0
    frames = torch.fft.irfft(by_frame, n=n_fft, dim=-1) * win
    del by_frame
    total = frames.shape[-2]
    wsq = (win * win).expand(total, n_fft)
    if f_valid is not None:
        fmask = (torch.arange(total, device=spec.device) < f_valid)[:, None]
        frames = torch.where(fmask, frames, torch.zeros((), dtype=frames.dtype, device=spec.device))
        wsq = torch.where(fmask, wsq, torch.zeros((), dtype=wsq.dtype, device=spec.device))
    signal = _overlap_add(frames, hop_length)
    wss = _overlap_add(wsq, hop_length)
    signal = signal / torch.clamp_min(wss, 1e-8)
    pad = n_fft // 2
    return signal[..., pad : pad + n_samples]
