"""Fused |STFT| (frame -> Hann window -> DFT -> |.|): CUDA kernel and
plain twin.

Counterpart of the JAX reference's ``ops/pallas_stft.py``
(``stft_magnitude``, Pallas kernel ``_kernel``). The hand-written CUDA
kernel ``csrc/stft_mag.cu`` computes the magnitude spectrogram of every
channel in (channels, bins, frames) layout without a framed signal or a
complex spectrum in device memory: the Hann window is folded into a
cached cos/sin DFT basis and the sums are float32 FMAs (see the source's
header for what bounds it).

``stft_magnitude`` launches the kernel for a CUDA tensor and runs
``stft_magnitude_reference`` (``frame_signal`` + the windowed basis +
two float32 matmuls + magnitude) for a CPU tensor. There is no fallback
from one to the other: a CUDA tensor gets the kernel or an exception.

``substrate.full_track_graph`` routes its shared [mid, side] STFT here
when ``switched_on()`` (``TA_PALLAS_STFT=1`` in the environment), as the
reference does; otherwise it uses ``ops/stft.magnitude`` (cuFFT on the
card).
"""

from __future__ import annotations

import ctypes
import os

import numpy as np
import torch

from . import cuda_build
from .stft import frame_signal, hann_window

__all__ = ["stft_magnitude", "stft_magnitude_reference", "switched_on", "windowed_basis"]

_BIN_TILE = 64  # the kernel's bins per block tile; the basis is padded to it
_TERM_TILE = 16  # the kernel's DFT terms per step; n_fft must divide by it
_basis_cache: dict = {}


def switched_on() -> bool:
    """Whether the fused graph takes this kernel for its [mid, side]
    STFT: ``TA_PALLAS_STFT=1`` in the environment, read on every call (the
    port runs eagerly, so a change applies to the next call)."""

    return os.environ.get("TA_PALLAS_STFT") == "1"


def windowed_basis(n_fft: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(n_fft, bins_p) float32 cos and sin DFT bases with the periodic
    Hann window folded into the rows, zero in the columns past the
    1 + n_fft//2 real bins (bins_p rounds up to the kernel's bin tile).
    The angle is 2*pi*((i*j) mod n_fft)/n_fft, as in the reference's
    ``_windowed_basis``, evaluated in float64. Cached per (n_fft, device)."""

    dev = torch.device(device)
    key = (n_fft, str(dev))
    if key not in _basis_cache:
        bins = 1 + n_fft // 2
        bins_p = -(-bins // _BIN_TILE) * _BIN_TILE
        i = np.arange(n_fft, dtype=np.int64)[:, None]
        j = np.arange(bins_p, dtype=np.int64)[None, :]
        ang = (2.0 * np.pi / n_fft) * ((i * j) % n_fft).astype(np.float64)
        win = hann_window(n_fft).astype(np.float64)[:, None]
        valid = j < bins
        wcos = np.where(valid, win * np.cos(ang), 0.0).astype(np.float32)
        wsin = np.where(valid, win * np.sin(ang), 0.0).astype(np.float32)
        _basis_cache[key] = (
            torch.from_numpy(wcos).to(dev).contiguous(),
            torch.from_numpy(wsin).to(dev).contiguous(),
        )
    return _basis_cache[key]


def _check(y: torch.Tensor, n_fft: int, hop_length: int, center: bool) -> tuple[torch.Tensor, int]:
    if y.dtype != torch.float32:
        raise TypeError(f"stft_magnitude takes float32, got {y.dtype}")
    if y.dim() == 1:
        y = y[None, :]
    if y.dim() != 2:
        raise ValueError(f"stft_magnitude takes (n,) or (C, n), got shape {tuple(y.shape)}")
    if n_fft % hop_length:
        raise ValueError(f"fused STFT needs hop-aligned frames: n_fft {n_fft} % hop {hop_length} != 0")
    pad = n_fft // 2 if center else 0
    if pad % hop_length:
        raise ValueError(f"fused STFT needs a centre pad ({pad}) that is a hop multiple")
    return y, pad


def stft_magnitude_reference(
    y: torch.Tensor, n_fft: int, hop_length: int, *, center: bool = True
) -> torch.Tensor:
    """The plain PyTorch version: frames @ windowed basis, twice, then the
    magnitude, in (C, 1 + n_fft//2, frames) layout."""

    y, _pad = _check(y, n_fft, hop_length, center)
    bins = 1 + n_fft // 2
    wcos, wsin = windowed_basis(n_fft, y.device)
    frames = frame_signal(y, n_fft, hop_length, center=center)  # (C, T, n_fft)
    re = frames @ wcos[:, :bins]
    im = frames @ wsin[:, :bins]
    return torch.sqrt(re * re + im * im).transpose(-1, -2).contiguous()


def _library() -> ctypes.CDLL:
    return cuda_build.load(
        "stft_mag.cu",
        "stft_mag_launch",
        [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ],
    )


def stft_magnitude(
    y: torch.Tensor, n_fft: int, hop_length: int, *, center: bool = True
) -> torch.Tensor:
    """|STFT| (periodic Hann, centred, zero-padded frames) of float32
    (C, n) or (n,) as (C, 1 + n_fft//2, frames), contiguous; a 1-D input
    gives C = 1, as in the reference.

    Raises when n_fft is not a multiple of ``hop_length`` or the centre
    pad is not a hop multiple, as the reference asserts. Each kernel
    launch adds one to ``stft_magnitude.launches``; the CPU path counts
    nothing."""

    y, pad = _check(y, n_fft, hop_length, center)
    if y.device.type == "cpu":
        return stft_magnitude_reference(y, n_fft, hop_length, center=center)
    if y.device.type != "cuda":
        raise ValueError(f"stft_magnitude takes a CPU or CUDA tensor, got {y.device}")
    if n_fft % _TERM_TILE:
        raise ValueError(f"the CUDA kernel needs n_fft divisible by {_TERM_TILE}, got {n_fft}")

    channels, n = y.shape
    bins = 1 + n_fft // 2
    frames = 1 + n // hop_length if center else 1 + (n - n_fft) // hop_length
    if frames < 1 or -(-frames // 64) > 65535 or channels > 65535:
        raise ValueError(f"stft_magnitude shape {tuple(y.shape)} exceeds the launch grid")
    out = torch.empty((channels, bins, frames), dtype=torch.float32, device=y.device)
    if channels == 0:
        return out
    y = y.contiguous()
    wcos, wsin = windowed_basis(n_fft, y.device)
    lib = _library()
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream(y.device).cuda_stream
        err = lib.stft_mag_launch(
            y.data_ptr(), wcos.data_ptr(), wsin.data_ptr(), out.data_ptr(),
            channels, n, n_fft, hop_length, pad, frames, bins, wcos.shape[1], stream,
        )
    if err != 0:
        raise RuntimeError(f"stft_magnitude kernel launch failed: CUDA error {err}")
    stft_magnitude.launches += 1
    return out


stft_magnitude.launches = 0
