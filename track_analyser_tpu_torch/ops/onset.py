"""Onset-strength envelope (spectral flux on the log-mel spectrogram).

The librosa convention of the JAX reference (``ops/onset.py``): log-mel,
positive first difference, mean over mel bands, and the centre-
compensation left-pad of lag + n_fft // (2 * hop) frames. The
autocorrelation is not ported: the host finisher recomputes it in
float64 from the envelope (``tempo.autocorrelate_host``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .mel import power_to_db

__all__ = ["onset_strength_from_mel"]


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
