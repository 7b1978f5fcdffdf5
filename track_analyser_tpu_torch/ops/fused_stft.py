"""Fused |STFT| (frame -> Hann window -> real FFT -> |.|): CUDA kernel,
its plain twin, and a CPU model of the kernel's algorithm.

Counterpart of the JAX reference's ``ops/pallas_stft.py``
(``stft_magnitude``, Pallas kernel ``_kernel``). The hand-written CUDA
kernel ``csrc/stft_mag.cu`` computes the magnitude spectrogram of every
channel in (channels, bins, frames) layout without a framed signal or a
complex spectrum in device memory. It takes each 2 048-sample frame as a
1 024-point complex sequence, transforms it with a 32 x 32 FFT that one
warp holds in registers (one exchange through shared memory), untangles
the real spectrum with warp shuffles, and stores the magnitudes of a run
of consecutive frames through a shared-memory tile (see the source's
header for what bounds it). The window, the FFT's twiddles and the
untangle factors come from ``fft_tables``: float64 values rounded once to
float32.

``stft_magnitude`` launches the kernel for a CUDA tensor and runs
``stft_magnitude_reference`` (``frame_signal`` + the windowed DFT basis +
two float32 matmuls + magnitude) for a CPU tensor. There is no fallback
from one to the other: a CUDA tensor gets the kernel or an exception.
``stft_magnitude_model`` walks the kernel's steps in plain PyTorch, lane
by lane and register by register, on the tables the kernel reads: it is
how the CPU tests catch a wrong twiddle, bit reversal or untangle.

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

__all__ = [
    "blocks_per_sm",
    "fft_tables",
    "stft_magnitude",
    "stft_magnitude_model",
    "stft_magnitude_reference",
    "switched_on",
    "windowed_basis",
]

KERNEL_N_FFT = 2048  # the one (n_fft, hop) pair the CUDA kernel is written for
KERNEL_HOP = 512
_BIN_TILE = 64  # the plain version's basis is padded to a multiple of it
_basis_cache: dict = {}
_tables_cache: dict = {}


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


def fft_tables(n_fft: int, device) -> torch.Tensor:
    """The kernel's tables for ``n_fft`` = 2048 as one flat float32 tensor
    of 5 120 values, each evaluated in float64 and rounded once:

    - [0, 2048): half the periodic Hann window (the untangle's factor 1/2
      folded in; halving is exact in float32);
    - [2048, 3072) and [3072, 4096): real and imaginary parts of the
      32 x 32 FFT's inner twiddles, exp(-2*pi*i * k1*n2 / 1024) at index
      32*k1 + n2 (a warp reads one row per register);
    - [4096, 4608) and [4608, 5120): real and imaginary parts of the
      untangle factors exp(-2*pi*i * k / 2048), k < 512 (bin 1024 - k
      shares bin k's factor, and bin 512's is -i).

    Cached per (n_fft, device)."""

    if n_fft != KERNEL_N_FFT:
        raise ValueError(f"the FFT kernel's tables exist for n_fft {KERNEL_N_FFT}, got {n_fft}")
    dev = torch.device(device)
    key = (n_fft, str(dev))
    if key not in _tables_cache:
        half = n_fft // 2
        k1 = np.arange(32, dtype=np.int64)[:, None]
        n2 = np.arange(32, dtype=np.int64)[None, :]
        inner = (2.0 * np.pi / half) * ((k1 * n2) % half).astype(np.float64).reshape(-1)
        untangle = (2.0 * np.pi / n_fft) * np.arange(half // 2, dtype=np.float64)
        window = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n_fft, dtype=np.float64) / n_fft)
        flat = np.concatenate(
            [0.5 * window, np.cos(inner), -np.sin(inner), np.cos(untangle), -np.sin(untangle)]
        ).astype(np.float32)
        _tables_cache[key] = torch.from_numpy(flat).to(dev).contiguous()
    return _tables_cache[key]


# exp(-2*pi*i * t / 32) = _W32_COS[t] - i * _W32_SIN[t], t < 16: the literals of
# the kernel's radix-2 passes (float64 rounded once to float32).
_W32_COS = np.cos(2.0 * np.pi * np.arange(16) / 32).astype(np.float32)
_W32_SIN = np.sin(2.0 * np.pi * np.arange(16) / 32).astype(np.float32)


def _brev5(k: int) -> int:
    return int(f"{k:05b}"[::-1], 2)


def _fft32_registers(re: list, im: list) -> None:
    """The kernel's 32-point FFT over a thread's 32 registers, in place:
    five radix-2 decimation-in-frequency passes, natural order in,
    bit-reversed out (X[k] ends in register ``_brev5(k)``). Each list
    item is a tensor over (..., lane)."""

    for half in (16, 8, 4, 2, 1):
        step = 16 // half
        for g in range(0, 32, 2 * half):
            for j in range(half):
                a, b = g + j, g + j + half
                dr, di = re[a] - re[b], im[a] - im[b]
                re[a], im[a] = re[a] + re[b], im[a] + im[b]
                t = j * step
                if t == 0:
                    re[b], im[b] = dr, di
                elif t == 8:  # times -i
                    re[b], im[b] = di, -dr
                elif t == 4:  # times (1 - i) / sqrt 2
                    re[b], im[b] = (dr + di) * _W32_COS[4], (di - dr) * _W32_COS[4]
                elif t == 12:  # times (-1 - i) / sqrt 2
                    re[b], im[b] = (di - dr) * _W32_COS[4], -(dr + di) * _W32_COS[4]
                else:
                    c, s = float(_W32_COS[t]), float(_W32_SIN[t])
                    re[b], im[b] = dr * c + di * s, di * c - dr * s


def stft_magnitude_model(
    y: torch.Tensor, n_fft: int, hop_length: int, *, center: bool = True
) -> torch.Tensor:
    """The CUDA kernel's algorithm in plain PyTorch, step by step on the
    float32 tables of ``fft_tables``: window (halved) and pack each frame
    as 1 024 complex points z[m] = x[2m] + i x[2m+1]; a 32 x 32 FFT in
    which lane n2 of a warp transforms its registers n1 (m = 32*n1 + n2),
    multiplies by the inner twiddles, exchanges so that lane k1 holds
    registers n2, and transforms again (Z[k1 + 32*k2] in register
    brev5(k2)); the untangle in pairs, X[k] = E + t and
    X[1024 - k] = conj(E - t) with E = Z[k] + conj Z[1024 - k],
    O = -i (Z[k] - conj Z[1024 - k]), t = w_k O, the partner fetched from
    lane (32 - lane) % 32; the magnitude. Only framing differs: the model
    takes ``frame_signal``'s zero-padded frames where the kernel reads a
    slab of the signal, and it takes an exact square root where the
    kernel's is within 2^-23."""

    y, _pad = _check(y, n_fft, hop_length, center)
    tables = fft_tables(n_fft, y.device)
    half = n_fft // 2
    window = tables[:n_fft]
    twr, twi = tables[n_fft : n_fft + half].view(32, 32), tables[n_fft + half : 2 * n_fft].view(32, 32)
    unr, uni = tables[2 * n_fft : 2 * n_fft + half // 2], tables[2 * n_fft + half // 2 :]

    framed = frame_signal(y, n_fft, hop_length, center=center) * window  # (C, T, n_fft)
    packed = framed.reshape(*framed.shape[:-1], 32, 32, 2)  # [n1][n2][re, im]
    re = [packed[..., n1, :, 0] for n1 in range(32)]
    im = [packed[..., n1, :, 1] for n1 in range(32)]
    _fft32_registers(re, im)
    plane_re, plane_im = [], []
    for k1 in range(32):  # lane n2 writes row k1 of the exchange plane
        r, i = re[_brev5(k1)], im[_brev5(k1)]
        plane_re.append(r * twr[k1] - i * twi[k1])
        plane_im.append(r * twi[k1] + i * twr[k1])
    plane_re, plane_im = torch.stack(plane_re, dim=-2), torch.stack(plane_im, dim=-2)  # [k1][n2]
    re = [plane_re[..., n2] for n2 in range(32)]  # lane k1 reads its row
    im = [plane_im[..., n2] for n2 in range(32)]
    _fft32_registers(re, im)

    lane = torch.arange(32, device=y.device)
    source = (32 - lane) % 32
    first = lane == 0
    mag = torch.empty(*framed.shape[:-1], half + 1, dtype=torch.float32, device=y.device)
    for k2 in range(16):
        a, b = re[_brev5(k2)], im[_brev5(k2)]
        # what each lane hands its partner: Z[1024 - k] sits in register
        # 31 - k2 of lane 32 - lane, but in register (32 - k2) % 32 of lane 0
        give_re = torch.where(first, re[_brev5((32 - k2) % 32)], re[_brev5(31 - k2)])
        give_im = torch.where(first, im[_brev5((32 - k2) % 32)], im[_brev5(31 - k2)])
        c, d = give_re[..., source], give_im[..., source]
        k = lane + 32 * k2
        wr, wi = unr[k], uni[k]
        er, ei, o_r, o_i = a + c, b - d, b + d, c - a
        tr = wr * o_r - wi * o_i
        ti = wr * o_i + wi * o_r
        mag[..., k] = torch.sqrt((er + tr) ** 2 + (ei + ti) ** 2)
        mag[..., half - k] = torch.sqrt((er - tr) ** 2 + (ei - ti) ** 2)
    a, b = re[_brev5(16)][..., 0], im[_brev5(16)][..., 0]  # lane 0: bin 512 is its own partner
    mag[..., half // 2] = 2.0 * torch.sqrt(a * a + b * b)
    return mag.transpose(-1, -2).contiguous()


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


# stft_mag_launch(y, tables, out, channels, n_samples, n_fft, hop, pad, frames, stream)
LAUNCH_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_void_p,
]


def _library() -> ctypes.CDLL:
    return cuda_build.load("stft_mag.cu", "stft_mag_launch", LAUNCH_ARGTYPES)


def blocks_per_sm() -> int:
    """Blocks of the built kernel that one SM holds at a time, as the CUDA
    runtime reckons it from its registers and shared memory."""

    blocks = _library().stft_mag_blocks_per_sm()
    if blocks < 0:
        raise RuntimeError(f"stft_mag_blocks_per_sm failed: CUDA error {-blocks}")
    return blocks


def stft_magnitude(
    y: torch.Tensor, n_fft: int, hop_length: int, *, center: bool = True
) -> torch.Tensor:
    """|STFT| (periodic Hann, centred, zero-padded frames) of float32
    (C, n) or (n,) as (C, 1 + n_fft//2, frames), contiguous; a 1-D input
    gives C = 1, as in the reference.

    Raises when n_fft is not a multiple of ``hop_length`` or the centre
    pad is not a hop multiple, as the reference asserts, and for a CUDA
    tensor with any (n_fft, hop) other than (2048, 512), the pair the
    kernel is written for. Each kernel launch adds one to
    ``stft_magnitude.launches``; the CPU path counts nothing."""

    y, pad = _check(y, n_fft, hop_length, center)
    if y.device.type == "cpu":
        return stft_magnitude_reference(y, n_fft, hop_length, center=center)
    if y.device.type != "cuda":
        raise ValueError(f"stft_magnitude takes a CPU or CUDA tensor, got {y.device}")
    if (n_fft, hop_length) != (KERNEL_N_FFT, KERNEL_HOP):
        raise ValueError(
            f"the CUDA kernel takes n_fft {KERNEL_N_FFT} and hop {KERNEL_HOP}, got {n_fft} and {hop_length}"
        )

    channels, n = y.shape
    bins = 1 + n_fft // 2
    frames = 1 + n // hop_length if center else 1 + (n - n_fft) // hop_length
    if frames < 1:
        raise ValueError(f"stft_magnitude shape {tuple(y.shape)} is shorter than one frame")
    out = torch.empty((channels, bins, frames), dtype=torch.float32, device=y.device)
    if channels == 0:
        return out
    y = y.contiguous()
    tables = fft_tables(n_fft, y.device)
    lib = _library()
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream(y.device).cuda_stream
        err = lib.stft_mag_launch(
            y.data_ptr(), tables.data_ptr(), out.data_ptr(),
            channels, n, n_fft, hop_length, pad, frames, stream,
        )
    if err != 0:
        raise RuntimeError(f"stft_magnitude kernel launch failed: CUDA error {err}")
    stft_magnitude.launches += 1
    return out


stft_magnitude.launches = 0
