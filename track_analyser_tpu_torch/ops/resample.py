"""Polyphase resampling, anti-aliased decimation and the true-peak
oversampler.

* ``resample_poly_host``: host-side scipy resampler used at load time.
* ``decimate_fir``: ``decim``-fold decimation as one banded-Toeplitz
  matmul over signal blocks (the CQ chroma's bass/mid banks).
* ``oversampled_peak``: BS.1770 true peak, the x8 polyphase upsampler as
  one (samples, taps) @ (taps, 8) matmul.

The filter designs are numpy functions with the JAX reference's
arithmetic, so their taps are bit-identical; the products are plain
``torch.matmul`` (float32, TF32 off, see ``device.py``).
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F
from scipy import signal as _scipy_signal

from ..device import device_constant
from .stft import frame_signal

__all__ = [
    "resample_poly_host",
    "polyphase_filter",
    "true_peak_oversample_matrix",
    "oversampled_peak",
    "decimate_fir",
]


@lru_cache(maxsize=8)
def _decimation_kernel(sr: int, decim: int, keep_hz: float) -> np.ndarray:
    """Blackman-windowed sinc lowpass for ``decim``-fold decimation.

    Only the band below ``keep_hz`` must survive uncorrupted, so the
    stopband starts where aliases would fold into that band
    (sr/decim - keep_hz), which keeps the kernel short."""

    pass_hz = keep_hz
    stop_hz = sr / decim - keep_hz
    if stop_hz <= pass_hz:
        raise ValueError(f"decimation keep_hz {keep_hz} too high for sr/decim {sr}/{decim}")
    taps = int(np.ceil(6.0 * sr / (stop_hz - pass_hz)))
    taps |= 1  # odd length -> integer group delay
    cutoff = 0.5 * (pass_hz + stop_hz) / (sr / 2.0)  # fraction of Nyquist
    n = np.arange(taps) - taps // 2
    h = cutoff * np.sinc(cutoff * n) * np.blackman(taps)
    h /= np.sum(h)
    return h.astype(np.float32)


@lru_cache(maxsize=8)
def _decimation_toeplitz(sr: int, decim: int, keep_hz: float, lanes: int) -> np.ndarray:
    """(3*lanes*decim, lanes) banded matrix computing ``lanes`` adjacent
    decimated outputs from one signal block (see decimate_fir)."""

    h = np.asarray(_decimation_kernel(sr, decim, keep_hz), dtype=np.float64)
    taps = h.size
    hop_block = lanes * decim
    if taps // 2 > hop_block:
        raise ValueError(f"decimation kernel ({taps} taps) exceeds the block span")
    mat = np.zeros((3 * hop_block, lanes), dtype=np.float64)
    for c in range(lanes):
        start = hop_block + c * decim - taps // 2
        mat[start : start + taps, c] = h
    return mat.astype(np.float32)


def decimate_fir(y: torch.Tensor, decim: int, *, sr: int, keep_hz: float) -> torch.Tensor:
    """Anti-aliased ``decim``-fold decimation of ``y`` (..., n) along its
    last axis.

    out[k] is centred on y[k*decim] (odd symmetric kernel, zero padding
    beyond both ends), so STFT frame grids of the decimated signal align
    with the full-rate grid. Block b of ``lanes`` outputs reads three
    blocks of input; all blocks go through one matmul."""

    if decim == 1:
        # Identity grid; one trailing zero matches the 1 + n//decim count.
        return F.pad(y, (0, 1))

    lanes = 128
    hop_block = lanes * decim
    n = y.shape[-1]
    m_out = 1 + n // decim
    n_blocks = -(-m_out // lanes)
    mat = device_constant(_decimation_toeplitz, sr, decim, keep_hz, lanes, device=y.device)
    length = 3 * hop_block
    # Block b reads ypad[b*hop_block : b*hop_block + 3*hop_block), where
    # ypad carries one leading block of zeros (kernel centre offset).
    pad_tail = (n_blocks - 1) * hop_block + length - hop_block - n
    ypad = F.pad(y, (hop_block, pad_tail))
    frames = frame_signal(ypad, length, hop_block, center=False)[..., :n_blocks, :]
    out = frames @ mat
    return out.reshape(y.shape[:-1] + (-1,))[..., :m_out]


def resample_poly_host(x: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Resample along the last axis using a kaiser-windowed polyphase FIR."""

    if orig_sr == target_sr:
        return np.asarray(x, dtype=np.float32)
    g = math.gcd(int(orig_sr), int(target_sr))
    up, down = target_sr // g, orig_sr // g
    out = _scipy_signal.resample_poly(
        np.asarray(x, dtype=np.float32), up, down, axis=-1
    )
    return np.asarray(out, dtype=np.float32)


def polyphase_filter(up: int, down: int = 1, *, beta: float = 5.0) -> np.ndarray:
    """Kaiser-windowed lowpass FIR for polyphase resampling, the design
    scipy.signal.resample_poly uses by default (window=('kaiser', 5.0),
    half-length 10*max(up, down))."""

    max_rate = max(up, down)
    half_len = 10 * max_rate
    n_taps = 2 * half_len + 1
    cutoff = 1.0 / max_rate  # fraction of Nyquist
    n = np.arange(n_taps) - half_len
    h = cutoff * np.sinc(cutoff * n)
    h *= np.kaiser(n_taps, beta)
    h /= np.sum(h)  # unity DC gain
    return (h * up).astype(np.float64)


@lru_cache(maxsize=8)
def true_peak_oversample_matrix(up: int) -> np.ndarray:
    """Polyphase matrix H of shape (n_rows, up): with frames
    X[n, i] = x[n + half_len//up - i], Y = X @ H gives Y[n, p] =
    y[up*n + p] of the zero-stuff-and-filter upsampler."""

    h = polyphase_filter(up, 1)
    n_taps = h.size  # 2*10*up + 1
    n_rows = int(np.ceil(n_taps / up))
    hpad = np.zeros(n_rows * up, dtype=np.float64)
    hpad[:n_taps] = h
    # H[i, p] = h[up*i + p]
    return hpad.reshape(n_rows, up).astype(np.float32)


def oversampled_peak(x: torch.Tensor, up: int = 8, *, mask: "torch.Tensor | None" = None) -> torch.Tensor:
    """max |polyphase-upsampled x| of ``x`` (..., n) along its last axis,
    one peak per lane.

    y[up*n + p] = sum_q x[n + shift - q] * h[up*q + p]: the reversed
    windows are an ``unfold`` of the padded signal read against H with
    its rows flipped.

    ``mask`` (optional, bool (n,)) restricts the max to the output rows
    whose leading input sample n is masked, while the interpolation still
    reads the true neighbouring samples: a sequence-sharded caller claims
    its own sample range this way without fabricating a zero step at a
    shard boundary (zeroing the input there would ring the interpolator)."""

    hmat = device_constant(true_peak_oversample_matrix, up, device=x.device)
    n_rows = hmat.shape[0]
    shift = (n_rows - 1) // 2  # = half_len // up = 10
    xp = F.pad(x, (n_rows - 1 - shift, shift))
    windows = xp.unfold(-1, n_rows, 1)  # windows[n, j] = xp[n + j]
    y = torch.abs(windows @ torch.flip(hmat, dims=(0,)))
    if mask is not None:
        y = torch.where(mask[:, None], y, torch.zeros((), dtype=y.dtype, device=y.device))
    return torch.amax(y, dim=(-2, -1))
