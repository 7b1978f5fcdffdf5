"""Onset-strength envelope (spectral flux on the log-mel spectrogram).

The librosa convention of the JAX reference (``ops/onset.py``): log-mel,
positive first difference, mean over mel bands, and the centre-
compensation left-pad of lag + n_fft // (2 * hop) frames; the local
autocorrelation tempogram of the report's plot; and the full
autocorrelation. The fused graph does not call ``autocorrelate``: the
host finisher computes it in float64 from the envelope
(``tempo.autocorrelate_host``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..device import device_constant
from .mel import power_to_db
from .stft import hann_window

__all__ = ["onset_strength_from_mel", "tempogram", "tempogram_prepadded", "autocorrelate"]


def onset_strength_from_mel(
    mel_power: torch.Tensor,
    *,
    n_fft: int,
    hop_length: int,
    lag: int = 1,
    center: bool = True,
) -> torch.Tensor:
    """Onset envelope from a mel POWER spectrogram (..., n_mels, n_frames);
    the dB floor is per (n_mels, n_frames) lane."""

    s_db = power_to_db(mel_power, dims=(-2, -1))
    flux = torch.clamp_min(s_db[..., lag:] - s_db[..., :-lag], 0.0)
    env = flux.mean(dim=-2)
    pad_width = lag + (n_fft // (2 * hop_length) if center else 0)
    env = F.pad(env, (pad_width, 0))
    if center:
        env = env[..., : mel_power.shape[-1]]
    return env


def tempogram(env: torch.Tensor, win_length: int = 384) -> torch.Tensor:
    """Local autocorrelation tempogram of an onset envelope (n_frames,).

    Returns (win_length, n_frames); each column is the hann-windowed
    autocorrelation of the envelope around that frame, inf-normalised. The
    envelope is padded by win_length // 2 on each side with a linear ramp
    down to zero (numpy's ``linear_ramp``)."""

    pad = win_length // 2
    ramp = torch.arange(pad, device=env.device, dtype=env.dtype) / pad
    left = env[..., :1] * ramp
    right = env[..., -1:] * (1.0 - (ramp + 1.0 / pad))
    return tempogram_prepadded(torch.cat([left, env, right], dim=-1), win_length)


def tempogram_prepadded(envp: torch.Tensor, win_length: int = 384) -> torch.Tensor:
    """:func:`tempogram` on an envelope already padded by win_length // 2 on
    each side, for callers that must construct the boundary ramps
    themselves (the bucket-padded report graph recreates the exact-shape
    ramp at f_valid, which may extend past the bucket's own end)."""

    pad = win_length // 2
    n = envp.shape[-1] - 2 * pad
    # frames[t, k] = envp[t + k]
    frames = envp.unfold(-1, win_length, 1)[..., :n, :]
    w = device_constant(hann_window, win_length, device=envp.device, dtype=envp.dtype)
    frames = frames * w
    n_pad = 1 << (2 * win_length - 2).bit_length()  # a power of two >= 2w - 1: linear
    spec = torch.fft.rfft(frames, n=n_pad, dim=-1)
    ac = torch.fft.irfft(spec * torch.conj(spec), n=n_pad, dim=-1)[..., :win_length]
    scale = ac.abs().amax(dim=-1, keepdim=True)
    ac = ac / torch.where(scale > 0, scale, torch.ones_like(scale))
    return ac.transpose(-1, -2)


def autocorrelate(y: torch.Tensor) -> torch.Tensor:
    """Full (not normalised) autocorrelation over the last axis, the
    input's length: ``irfft(|rfft(y)|^2)`` at the power of two at or above
    2n - 1 (so linear, not circular), first n lags."""

    n = y.shape[-1]
    n_pad = 1 << (2 * n - 2).bit_length()
    spec = torch.fft.rfft(y, n=n_pad, dim=-1)
    return torch.fft.irfft(spec * torch.conj(spec), n=n_pad, dim=-1)[..., :n]
