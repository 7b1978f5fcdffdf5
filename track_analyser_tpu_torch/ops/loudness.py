"""EBU R128 / ITU-R BS.1770 loudness, gated, on tensors.

The K-weighting cascade (high-shelf + RLB high-pass biquads) is applied
as an FFT convolution with the cascade's truncated impulse response:
one transform for signals of at most 4*32768 samples, overlap-save with
power-of-two blocks above that. These are the JAX reference's non-TPU
branches; its 2048-tap Toeplitz matmul is TPU-only and not ported.

Gating (400 ms blocks, 75% overlap, -70 LUFS absolute and -10 LU
relative gates) is a set of masked reductions over framed energies.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..device import device_constant
from .mel import amplitude_to_db
from .stft import frame_signal

__all__ = [
    "k_weighting_coeffs",
    "k_weighting_fir",
    "k_weighted",
    "framed_energy",
    "integrated_lufs",
    "rms_db_curve",
    "ebu_loudness_range",
]


def _high_shelf(fs: float, gain_db: float, q: float, fc: float) -> Tuple[np.ndarray, np.ndarray]:
    """BS.1770 stage-1 pre-filter (head-effect high shelf)."""

    k = np.tan(np.pi * fc / fs)
    vh = 10.0 ** (gain_db / 20.0)
    vb = vh**0.4996667741545416
    a0 = 1.0 + k / q + k * k
    b = np.array(
        [
            (vh + vb * k / q + k * k) / a0,
            2.0 * (k * k - vh) / a0,
            (vh - vb * k / q + k * k) / a0,
        ]
    )
    a = np.array([1.0, 2.0 * (k * k - 1.0) / a0, (1.0 - k / q + k * k) / a0])
    return b, a


def _high_pass(fs: float, q: float, fc: float) -> Tuple[np.ndarray, np.ndarray]:
    """BS.1770 stage-2 RLB high pass."""

    k = np.tan(np.pi * fc / fs)
    denom = 1.0 + k / q + k * k
    a = np.array([1.0, 2.0 * (k * k - 1.0) / denom, (1.0 - k / q + k * k) / denom])
    b = np.array([1.0, -2.0, 1.0])
    return b, a


def k_weighting_coeffs(fs: float):
    """The two K-weighting biquads for sample rate ``fs``."""

    shelf = _high_shelf(fs, gain_db=3.999843853973347, q=0.7071752369554193, fc=1681.9744509555319)
    hp = _high_pass(fs, q=0.5003270373253953, fc=38.13547087613982)
    return shelf, hp


@lru_cache(maxsize=16)
def k_weighting_fir(fs: int, n_taps: int = 16_384) -> np.ndarray:
    """Truncated impulse response of the K-weighting cascade."""

    from scipy.signal import lfilter

    (b1, a1), (b2, a2) = k_weighting_coeffs(float(fs))
    x = np.zeros(n_taps)
    x[0] = 1.0
    h = lfilter(b2, a2, lfilter(b1, a1, x))
    return h.astype(np.float32)


def _k_weighting_spectrum(fs: int, n_fft: int) -> np.ndarray:
    """``rfft`` of ``k_weighting_fir(fs)`` at ``n_fft``, complex64."""

    return np.fft.rfft(k_weighting_fir(fs), n=n_fft).astype(np.complex64)


def k_weighted(y: torch.Tensor, fs: int) -> torch.Tensor:
    """K-weighting by FFT convolution (same length as the input).

    One whole-signal transform for n <= 4*32768; overlap-save with
    32768-sample blocks above that (the same linear convolution)."""

    h_np = k_weighting_fir(fs)
    taps = int(h_np.shape[0])
    n = y.shape[-1]
    block = 32_768
    if n <= 4 * block:
        h = device_constant(k_weighting_fir, fs, device=y.device)
        n_fft = int(2 ** np.ceil(np.log2(n + taps - 1)))
        spec = torch.fft.rfft(y, n=n_fft) * torch.fft.rfft(h, n=n_fft)
        return torch.fft.irfft(spec, n=n_fft)[..., :n]

    n_fft = 1 << int(np.ceil(np.log2(block + taps - 1)))
    nb = -(-n // block)
    spec_h = device_constant(_k_weighting_spectrum, fs, n_fft, device=y.device)
    # Left-pad taps-1 (causal history); block i reads n_fft samples
    # starting at i*block of the padded signal.
    k = n_fft // block
    total = (nb + k - 1) * block
    yp = F.pad(y, (taps - 1, total - (taps - 1) - n))
    frames = yp.unfold(-1, n_fft, block)[..., :nb, :]  # (..., nb, n_fft)
    out = torch.fft.irfft(torch.fft.rfft(frames, dim=-1) * spec_h, n=n_fft, dim=-1)
    out = out[..., taps - 1 : taps - 1 + block]
    return out.reshape(y.shape[:-1] + (nb * block,))[..., :n]


def framed_energy(
    y: torch.Tensor, frame_length: int, hop_length: int, *, center: bool
) -> torch.Tensor:
    """Per-frame energy sum(y[frame]^2) of ``y`` (..., n) along its last
    axis, without materialising the framed tensor when frame_length is a
    multiple of hop_length: per-hop-chunk energy partials, then a k-term
    sum per frame."""

    n = y.shape[-1]
    k = frame_length // hop_length
    pad = frame_length // 2 if center else 0
    if frame_length % hop_length or (center and pad % hop_length):
        frames = frame_signal(y, frame_length, hop_length, center=center)
        return (frames * frames).sum(dim=-1)
    total = 1 + n // hop_length if center else 1 + (n - frame_length) // hop_length
    need = total - 1 + k
    tail = need * hop_length - (pad + n)
    yp = F.pad(y, (pad, max(tail, 0)))[..., : need * hop_length]
    part = torch.square(yp.reshape(y.shape[:-1] + (need, hop_length))).sum(dim=-1)
    out = part[..., 0:total]
    for j in range(1, k):
        out = out + part[..., j : j + total]
    return out


def integrated_lufs(
    y: torch.Tensor,
    fs: int,
    *,
    block_seconds: float = 0.400,
    overlap: float = 0.75,
    absolute_gate: float = -70.0,
    relative_gate_lu: float = -10.0,
    n_valid: "int | torch.Tensor | None" = None,
) -> torch.Tensor:
    """Gated integrated loudness (BS.1770-4) of ``y`` (..., n), one value
    per lane.

    ``n_valid`` marks the true sample count of a bucket-padded signal (an
    int, or a tensor of the lanes' batch shape): blocks that extend past
    it are excluded, which reproduces the exact-shape result."""

    yk = k_weighted(y, fs)
    frame_len = int(round(block_seconds * fs))
    hop = int(round(block_seconds * (1.0 - overlap) * fs))
    dev = y.device
    if yk.shape[-1] < frame_len:
        # Too short to gate: fall back to whole-signal energy.
        z = torch.mean(yk * yk, dim=-1, keepdim=True)
        block_ok = torch.ones(z.shape, dtype=torch.bool, device=dev)
    else:
        z = framed_energy(yk, frame_len, hop, center=False) / frame_len
        if n_valid is not None:
            starts = torch.arange(z.shape[-1], device=dev) * hop
            block_ok = (starts + frame_len) <= torch.as_tensor(n_valid, device=dev)[..., None]
        else:
            block_ok = torch.ones(z.shape, dtype=torch.bool, device=dev)

    eps = 1e-20
    zero = torch.zeros((), dtype=z.dtype, device=dev)
    loud = -0.691 + 10.0 * torch.log10(z + eps)

    abs_mask = block_ok & (loud > absolute_gate)
    abs_count = torch.clamp_min(abs_mask.sum(dim=-1), 1)
    z_abs = torch.where(abs_mask, z, zero).sum(dim=-1) / abs_count
    gamma_r = -0.691 + 10.0 * torch.log10(z_abs + eps) + relative_gate_lu

    both_mask = abs_mask & (loud > gamma_r[..., None])
    count = torch.clamp_min(both_mask.sum(dim=-1), 1)
    z_gated = torch.where(both_mask, z, zero).sum(dim=-1) / count
    return -0.691 + 10.0 * torch.log10(z_gated + eps)


def rms_db_curve(y: torch.Tensor, frame_length: int, hop_length: int) -> torch.Tensor:
    """Sliding-window RMS in dB of ``y`` (..., n) (centred frames,
    amplitude_to_db with an 80 dB floor below each lane's own peak)."""

    rms = torch.sqrt(framed_energy(y, frame_length, hop_length, center=True) / frame_length)
    return amplitude_to_db(rms + 1e-9, ref=1.0, top_db=80.0, dims=(-1,))


def ebu_loudness_range(y: torch.Tensor, fs: int) -> torch.Tensor:
    """EBU Tech 3342 loudness range (LU) of a mono signal ``y`` (n,): the
    spread of the gated 3 s short-term loudness, 1 s apart.

    Blocks pass an absolute gate of -70 LUFS and a relative gate 20 LU
    under their mean energy; the range is the 95th minus the 10th
    percentile, read as the JAX reference reads them: the sorted gated
    values at ``int(0.10 * (n - 1))`` and ``int(0.95 * (n - 1))`` (float32
    products, truncated). 0 for a signal shorter than 3 s or with at most
    one gated block."""

    yk = k_weighted(y, fs)
    frame_len = int(round(3.0 * fs))
    hop = int(round(1.0 * fs))
    zero = torch.zeros((), dtype=yk.dtype, device=yk.device)
    if yk.shape[-1] < frame_len:
        return zero
    frames = frame_signal(yk, frame_len, hop, center=False)
    z = torch.mean(frames * frames, dim=-1)
    eps = 1e-20
    loud = -0.691 + 10.0 * torch.log10(z + eps)
    abs_mask = loud > -70.0
    n_abs = torch.clamp_min(abs_mask.sum(), 1)
    z_abs = torch.where(abs_mask, z, zero).sum() / n_abs
    rel_thresh = -0.691 + 10.0 * torch.log10(z_abs + eps) - 20.0
    mask = abs_mask & (loud > rel_thresh)
    order = torch.sort(torch.where(mask, loud, torch.full_like(loud, 1e9))).values
    n_valid = mask.sum()
    last = loud.shape[0] - 1
    lo_idx = torch.clamp((0.10 * (n_valid - 1)).to(torch.int32), 0, last)
    hi_idx = torch.clamp((0.95 * (n_valid - 1)).to(torch.int32), 0, last)
    lra = order[hi_idx] - order[lo_idx]
    return torch.where(n_valid > 1, lra, zero)
