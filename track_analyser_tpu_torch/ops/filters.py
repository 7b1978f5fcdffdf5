"""Smoothing and median filtering primitives.

``gaussian_filter1d`` reproduces scipy.ndimage semantics (truncate=4.0,
reflect boundary), with the two branches of the JAX reference: shifted
multiply-adds for kernels of at most 48 taps, one FFT convolution above
that. ``median_filter_1d`` is the plain sliding median; HPSS's two
medians of 31 go through ``ops/median.median31``, which launches a
hand-written CUDA kernel for tensors on the card: each thread computes 16
neighbouring outputs, whose windows share a sorted core, with 32.375
min/max an output (``ops/median.tile_network``), so the bytes it must
move bound the kernel, not its min/max.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..device import device_constant

__all__ = [
    "reflect_index",
    "gaussian_kernel",
    "gaussian_filter1d",
    "median_filter_1d",
    "softmask",
    "hpss",
]


def reflect_index(n: int, left: int, right: int, device) -> torch.Tensor:
    """Source index of every position of ``x`` padded by (left, right)
    with numpy's ``reflect`` mode (the edge sample is not repeated;
    pads longer than the signal keep bouncing)."""

    i = torch.arange(-left, n + right, device=device)
    if n == 1:
        return torch.zeros_like(i)
    period = 2 * (n - 1)
    i = torch.remainder(i, period)
    return torch.where(i < n, i, period - i)


@lru_cache(maxsize=32)
def gaussian_kernel(sigma: float, truncate: float = 4.0) -> np.ndarray:
    radius = int(truncate * sigma + 0.5)
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def gaussian_filter1d(x: torch.Tensor, sigma: float, axis: int = -1) -> torch.Tensor:
    """Gaussian smoothing along ``axis`` with reflect boundaries."""

    kernel_np = gaussian_kernel(float(sigma))
    ksize = kernel_np.shape[0]
    radius = ksize // 2
    x = torch.movedim(x, axis, -1)
    n = x.shape[-1]
    xp = x.index_select(-1, reflect_index(n, radius, radius, x.device))

    if ksize <= 48:
        y = torch.zeros_like(x)
        for j in range(ksize):
            y = y + float(kernel_np[j]) * xp[..., j : j + n]
    else:
        n_fft = int(2 ** np.ceil(np.log2(xp.shape[-1] + ksize)))
        kernel = device_constant(gaussian_kernel, float(sigma), device=x.device)
        spec = torch.fft.rfft(xp, n=n_fft, dim=-1) * torch.fft.rfft(kernel, n=n_fft)
        # FFT computes convolution; for the symmetric kernel correlation
        # equals convolution shifted by ksize-1 relative to the padded
        # input: y[t] = conv[t + ksize - 1].
        y = torch.fft.irfft(spec, n=n_fft, dim=-1)[..., ksize - 1 : ksize - 1 + n]
    return torch.movedim(y, -1, axis)


def median_filter_1d(
    x: torch.Tensor, size: int, axis: int = -1, *, chunk: int = 512
) -> torch.Tensor:
    """Sliding median along ``axis`` with reflect boundaries (scipy-style
    origin at size//2; HPSS uses odd sizes only).

    The windows are ``unfold`` views over ``chunk`` output positions at a
    time, so the materialised window tensor stays bounded (a 3-minute
    spectrogram would otherwise need a ~2 GB one)."""

    x = torch.movedim(x, axis, -1)
    n = x.shape[-1]
    left = size // 2
    right = size - 1 - left
    xp = x.index_select(-1, reflect_index(n, left, right, x.device))
    parts = []
    for start in range(0, n, chunk):
        stop = min(n, start + chunk)
        win = xp[..., start : stop + size - 1].unfold(-1, size, 1)
        parts.append(win.median(dim=-1).values)
    y = torch.cat(parts, dim=-1)
    return torch.movedim(y, -1, axis)


def softmask(
    x: torch.Tensor, x_ref: torch.Tensor, *, power: float = 2.0, split_zeros: bool = True
) -> torch.Tensor:
    """librosa-style soft mask: (X/Z)^p / ((X/Z)^p + (Xref/Z)^p)."""

    tiny = torch.finfo(x.dtype).tiny
    z = torch.clamp_min(torch.maximum(x, x_ref), tiny)
    ref_p = (x_ref / z) ** power
    x_p = (x / z) ** power
    mask = x_p / (x_p + ref_p)
    bad = torch.maximum(x, x_ref) < tiny
    fill = 0.5 if split_zeros else 0.0
    return torch.where(bad, torch.full_like(mask, fill), mask)


def hpss(
    s: torch.Tensor, *, kernel_size: int = 31, power: float = 2.0
) -> tuple[torch.Tensor, torch.Tensor]:
    """Harmonic/percussive separation of a magnitude spectrogram (freq, time).

    Median along time for the harmonic reference, along frequency for the
    percussive reference, then soft masks (librosa.decompose.hpss
    defaults, margin=1). The default kernel size runs through
    ``median31``: the CUDA kernel on the card, its plain twin on the CPU.
    """

    if kernel_size == 31:
        from .median import median31

        s = s.contiguous()
        harm_ref = median31(s, axis=-1)
        perc_ref = median31(s, axis=-2)
    else:
        harm_ref = median_filter_1d(s, kernel_size, axis=-1)
        perc_ref = median_filter_1d(s, kernel_size, axis=-2)
    mask_h = softmask(harm_ref, perc_ref, power=power, split_zeros=True)
    mask_p = softmask(perc_ref, harm_ref, power=power, split_zeros=True)
    return s * mask_h, s * mask_p
