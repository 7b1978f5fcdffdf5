"""Sliding median of 31 (HPSS's two medians): CUDA kernel and plain twin.

Counterpart of the JAX reference's ``ops/pallas_median.py``. One
hand-written CUDA kernel source, ``csrc/median31.cu``, replaces both
Pallas TPU kernels: ``_median31_kernel`` (``median31_last_axis``, along
time, the harmonic reference) and ``_median31_rows_kernel``
(``median31_first_axis``, along frequency, the percussive reference).

The design: each thread computes a run of ``r`` consecutive outputs
(``RUN_TIME`` along time, ``RUN_FREQ`` along frequency). The ``r``
windows of a run share a core of ``32 - r`` inputs, which is sorted once.
Of a sorted core common to ``s`` windows only the ``s`` ranks
``16 - s .. 15`` can still become a window's median: that band is all a
node keeps. The run is then halved again and again; a half that adds
``e`` inputs merges them, sorted, into its parent's band and keeps ranks
``e .. s - 1`` of the merge as its own, down to one clamp of the last new
input between two sorted neighbours. Sorted runs of inputs are built by
halves and reused wherever two merges need the same one, and backward
liveness drops every min/max that no output reads: ``tile_network(16)``
needs 518 min/max for 16 outputs, 32.375 per output, against 351 for a
32-wide bitonic network pruned to rank 15 (the earlier design).
``tile_network`` generates the schedule, and ``cuda_block`` writes it as
straight-line CUDA into a marked block of the source (``python -m
track_analyser_tpu_torch.ops.median`` rewrites the block);
``median31_network`` runs the same schedule with ``torch.minimum`` /
``torch.maximum`` on the CPU, so a test holds the very network the card
runs to the plain version.

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
from functools import lru_cache
from typing import NamedTuple

import torch

from . import cuda_build
from .filters import median_filter_1d, reflect_index

__all__ = [
    "RUN_TIME", "RUN_FREQ", "TileNetwork", "tile_network", "cuda_block", "source_block", "median31_network",
    "median31", "median31_reference",
]

_SIZE = 31
_RADIUS = _SIZE // 2
# Outputs per thread of the kernel along each axis (csrc/median31.cu).
RUN_TIME = 16
RUN_FREQ = 16
BLOCK_BEGIN = "// BEGIN GENERATED BLOCK"
BLOCK_END = "// END GENERATED BLOCK"


class TileNetwork(NamedTuple):
    """The min/max schedule of one run of ``r`` consecutive medians.

    Values 0 .. r + 29 are the run's inputs in order (output ``j`` is the
    median of inputs ``j .. j + 30``); op ``i`` = (is_max, a, b) makes
    value ``r + 30 + i`` as the min (or max) of values ``a`` and ``b``;
    ``outputs[j]`` is the value that holds output ``j``."""

    r: int
    ops: tuple
    outputs: tuple

    @property
    def count(self) -> int:
        return len(self.ops)

    @property
    def per_output(self) -> float:
        return len(self.ops) / self.r


@lru_cache(maxsize=None)
def tile_network(r: int) -> TileNetwork:
    """The pruned shared-core network for a run of ``r`` (1 .. 32)
    medians of 31: sort the common core once, halve the run, merge each
    half's new inputs into the band of its parent's core that can still
    hold a median (Batcher's odd-even merge), and keep only what reaches
    rank 15 of a window."""

    if not 1 <= r <= _SIZE + 1:
        raise ValueError(f"a run shares a core only for 1 <= r <= 32, got {r}")
    n = r + 2 * _RADIUS
    ops: list = []

    def emit(is_max: bool, a: int, b: int) -> int:
        ops.append((is_max, a, b))
        return n + len(ops) - 1

    def merge(a: list, b: list) -> list:
        """Batcher's odd-even merge of two sorted lists of any lengths."""

        if not a or not b:
            return a + b
        if len(a) == 1 and len(b) == 1:
            return [emit(False, a[0], b[0]), emit(True, a[0], b[0])]
        even = merge(a[0::2], b[0::2])
        odd = merge(a[1::2], b[1::2])
        out = [even[0]]
        i = 1
        while i < len(even) and i <= len(odd):
            out += [emit(False, even[i], odd[i - 1]), emit(True, even[i], odd[i - 1])]
            i += 1
        return out + even[i:] + odd[i - 1 :]

    sorted_runs: dict = {}

    def sort(lo: int, hi: int) -> list:
        """Inputs lo .. hi - 1 sorted, by halves; every range is built once."""

        if hi - lo <= 1:
            return list(range(lo, hi))
        if (lo, hi) not in sorted_runs:
            mid = (lo + hi) // 2
            sorted_runs[(lo, hi)] = merge(sort(lo, mid), sort(mid, hi))
        return sorted_runs[(lo, hi)]

    outputs = [0] * r

    def split(lo: int, hi: int, band: list) -> None:
        """Windows lo .. hi - 1 (s of them, s <= 16), ``band`` the ranks
        16 - s .. 15 of their common inputs, sorted: only these can become
        some window's rank 15. A half that adds e inputs keeps ranks
        e .. s - 1 of the merge of ``band`` with them (its own band)."""

        if hi - lo == 1:
            outputs[lo] = band[0]
            return
        mid = (lo + hi) // 2
        extra = sort(mid - 1, hi - 1)
        split(lo, mid, merge(band, extra)[len(extra) : len(band)])
        extra = sort(lo + _SIZE, mid + _SIZE)
        split(mid, hi, merge(band, extra)[len(extra) : len(band)])

    def start(lo: int, hi: int, core: list) -> None:
        """Windows lo .. hi - 1, whose common inputs hi - 1 .. lo + 30 are
        ``core``, sorted; runs longer than 16 halve before keeping a band."""

        s = hi - lo
        if s <= _RADIUS + 1:
            split(lo, hi, core[_RADIUS + 1 - s : _RADIUS + 1])
            return
        mid = (lo + hi) // 2
        start(lo, mid, merge(core, sort(mid - 1, hi - 1)))
        start(mid, hi, merge(core, sort(lo + _SIZE, mid + _SIZE)))

    start(0, r, sort(r - 1, _SIZE))

    # Backward liveness: an op is kept if a kept op or an output reads it.
    live = set(outputs)
    kept = []
    for i in range(len(ops) - 1, -1, -1):
        if n + i in live:
            kept.append(i)
            live.update(ops[i][1:])
    kept.reverse()
    renumber = {v: v for v in range(n)}
    pruned = []
    for new, i in enumerate(kept):
        is_max, a, b = ops[i]
        pruned.append((is_max, renumber[a], renumber[b]))
        renumber[n + i] = n + new
    return TileNetwork(r, tuple(pruned), tuple(renumber[v] for v in outputs))


def cuda_block(runs: "tuple[int, int]" = (RUN_TIME, RUN_FREQ)) -> str:
    """The generated block of ``csrc/median31.cu`` (between its markers,
    which it includes): the run lengths along time and frequency and one
    ``Median31Net<r>::run`` of straight-line min/max for each."""

    run_time, run_freq = runs
    lines = [
        BLOCK_BEGIN,
        "// Written by track_analyser_tpu_torch/ops/median.py (cuda_block); do not edit:",
        "// python -m track_analyser_tpu_torch.ops.median rewrites it.",
        f"constexpr int kRunTime = {run_time};",
        f"constexpr int kRunFreq = {run_freq};",
    ]
    for r in sorted(set(runs)):
        net = tile_network(r)
        n = r + 2 * _RADIUS

        def name(v: int) -> str:
            return f"v[{v}]" if v < n else f"t{v - n}"

        lines += [
            "",
            f"// {net.count} min/max for {r} outputs: {net.per_output:g} per output.",
            "template <>",
            f"struct Median31Net<{r}> {{",
            f"  static constexpr int kMinMax = {net.count};",
            f"  static __device__ __forceinline__ void run(const float (&v)[{n}], float (&m)[{r}]) {{",
        ]
        for i, (is_max, a, b) in enumerate(net.ops):
            lines.append(f"    const float t{i} = {'fmaxf' if is_max else 'fminf'}({name(a)}, {name(b)});")
        lines += [f"    m[{j}] = {name(v)};" for j, v in enumerate(net.outputs)]
        lines += ["  }", "};"]
    lines.append(BLOCK_END)
    return "\n".join(lines) + "\n"


def source_block(text: str) -> str:
    """The generated block (markers included) inside CUDA source ``text``."""

    start = text.index(BLOCK_BEGIN)
    stop = text.index(BLOCK_END, start) + len(BLOCK_END) + 1
    return text[start:stop]


def median31_network(x: torch.Tensor, axis: int = -1, r: int = RUN_TIME) -> torch.Tensor:
    """The kernel's algorithm in plain PyTorch: ``tile_network(r)`` run
    with ``torch.minimum`` / ``torch.maximum`` over runs of ``r`` outputs
    of the reflect-padded ``axis``, as each thread of the kernel runs it.
    Equal bit for bit to ``median31_reference``."""

    net = tile_network(r)
    x = torch.movedim(x, axis, -1)
    length = x.shape[-1]
    runs = -(-length // r)
    padded = x.index_select(
        -1, reflect_index(length, _RADIUS, runs * r + _RADIUS - length, x.device)
    )
    values = [padded[..., k : k + (runs - 1) * r + 1 : r] for k in range(r + 2 * _RADIUS)]
    for is_max, a, b in net.ops:
        values.append(torch.maximum(values[a], values[b]) if is_max else torch.minimum(values[a], values[b]))
    y = torch.stack([values[v] for v in net.outputs], dim=-1).flatten(-2)[..., :length]
    return torch.movedim(y, -1, axis)


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
    # The grid is (blocks of a plane, batch).
    if batch > 65535 or rows * cols >= 2**31:
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
    cuda_build.count_launch(median31, "launches", "launches_time" if axis_time else "launches_freq")
    return out


median31.launches = 0
median31.launches_time = 0
median31.launches_freq = 0


if __name__ == "__main__":
    source = cuda_build.CSRC / "median31.cu"
    text = source.read_text()
    source.write_text(text.replace(source_block(text), cuda_block()))
    print(f"{source}: generated block written (runs {RUN_TIME} along time, {RUN_FREQ} along frequency)")
