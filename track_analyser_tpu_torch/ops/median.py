"""Sliding median of 31 (HPSS's two medians): CUDA kernel and plain twin.

Counterpart of the JAX reference's ``ops/pallas_median.py``. One
hand-written CUDA kernel, ``csrc/median31.cu``, replaces both Pallas TPU
kernels: ``_median31_kernel`` (``median31_last_axis``, along time, the
harmonic reference) and ``_median31_rows_kernel``
(``median31_first_axis``, along frequency, the percussive reference).

The kernel reads and writes the spectrogram once; what bounds it on an
H100 is the 351 min/max per output of the pruned 32-wide bitonic
network, not memory (see the source's header for the measured numbers).
Threads run along the contiguous time axis for both medians, so every
window load is coalesced without a transpose, reflect indices are
computed in the kernel only near an edge (no padded copy), and the
network lives in registers.

``median31`` launches the kernel for a CUDA tensor and runs
``median31_reference`` (unfold + median, chunked) for a CPU tensor.
There is no fallback from one to the other: a CUDA tensor gets the
kernel or an exception.

The kernel is compiled at first use by ``cuda_build`` (``nvcc``,
``sm_90a``, a plain-C shared library under ``build/torch_kernels/``)
and bound with ``ctypes``.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build
from .filters import median_filter_1d

__all__ = ["median31", "median31_reference"]

_SIZE = 31


def median31_reference(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """The plain PyTorch version: exact sliding median of 31 with reflect
    boundaries (``unfold`` + ``median``, chunked)."""

    return median_filter_1d(x, _SIZE, axis)


def _library() -> ctypes.CDLL:
    return cuda_build.load(
        "median31.cu",
        "median31_launch",
        [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ],
    )


def median31(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Sliding median of 31 along ``axis`` (-1: time, -2: frequency) of a
    contiguous float32 (F, T) or (B, F, T) tensor, reflect boundaries.

    Equal bit for bit to ``median31_reference``. Each kernel launch adds
    one to ``median31.launches`` (and to ``launches_time`` or
    ``launches_freq``); the CPU path counts nothing."""

    if x.dtype != torch.float32:
        raise TypeError(f"median31 takes float32, got {x.dtype}")
    if x.dim() not in (2, 3):
        raise ValueError(f"median31 takes (F, T) or (B, F, T), got shape {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("median31 takes a contiguous tensor")
    if axis not in (-1, -2, x.dim() - 1, x.dim() - 2):
        raise ValueError(f"median31 runs along the last two axes, got axis={axis}")
    axis_time = axis in (-1, x.dim() - 1)
    if x.device.type == "cpu":
        return median31_reference(x, -1 if axis_time else -2)
    if x.device.type != "cuda":
        raise ValueError(f"median31 takes a CPU or CUDA tensor, got {x.device}")

    rows, cols = x.shape[-2:]
    batch = x.shape[0] if x.dim() == 3 else 1
    if (rows + 3) // 4 > 65535 or batch > 65535 or rows * cols >= 2**31:
        raise ValueError(f"median31 shape {tuple(x.shape)} exceeds the launch grid")
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.median31_launch(
            x.data_ptr(), out.data_ptr(), batch, rows, cols, int(axis_time), stream
        )
    if err != 0:
        raise RuntimeError(f"median31 kernel launch failed: CUDA error {err}")
    median31.launches += 1
    if axis_time:
        median31.launches_time += 1
    else:
        median31.launches_freq += 1
    return out


median31.launches = 0
median31.launches_time = 0
median31.launches_freq = 0
