"""Where the fused |STFT| kernel spends its time on a CUDA card.

    python -m track_analyser_tpu_torch.profile_stft [--channels 2 8] [--reps 10]

The card's profilers may be out of reach, so the kernel is taken apart
instead: ``csrc/stft_mag.cu`` is built as it is and in edited copies, each
with one part removed or replaced, and all are timed with CUDA events on
(channels, 8 388 608) float32 noise, the sweep's bucket. Every copy but
the first computes something wrong or slower on purpose; none is used
outside this script:

- ``as built``: the kernel the port launches;
- ``no stores``: everything but the writes to device memory;
- ``no transform``: slab copies, barriers and stores of an unwritten tile;
- ``exact sqrt``: ``sqrtf`` in place of ``sqrt.approx``;
- ``plain stores``: the stores without their L2 evict-last hint;
- ``runs stored as they lie``: no carry, each run's 16 frames of a bin
  written where they fall, so both ends of every run write part of a
  32-byte sector (the output's rows have an odd length);
- ``one run per stretch``: the carry kept, but every run a stretch of its
  own, so neighbouring runs go to concurrent blocks.

Beside them: the time to overwrite the output (``zero_``) and to copy the
input, the card's name and power limit, and the kernel's registers,
shared memory and blocks per SM. One more copy (``PHASE_EDITS``) reads
``clock64`` between the kernel's phases and reports, per run of 16 frames,
the SM cycles thread 0 of a block spends in each (mean over blocks), with
and without the stores. Needs a CUDA card and ``nvcc``.
"""

from __future__ import annotations

import argparse
import ctypes
import statistics
import subprocess

import numpy as np
import torch

from .device import resolve_device
from .ops import cuda_build, fused_stft

BUCKET = 8_388_608
N_FFT, HOP = fused_stft.KERNEL_N_FFT, fused_stft.KERNEL_HOP

# name -> [(text in csrc/stft_mag.cu, its replacement)]
EDITS = {
    "as built": [],
    "no stores": [("if (write) store_keep_in_l2(dst, *src, policy);", "if (write && pad < 0) store_keep_in_l2(dst, *src, policy);")],
    "no transform": [("const bool active = f0 + warp < frames;", "const bool active = f0 + warp < frames - (1 << 30);")],
    "exact sqrt": [('asm("sqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));', "r = sqrtf(x);")],
    "plain stores": [("createpolicy.fractional.L2::evict_last.b64", "createpolicy.fractional.L2::evict_normal.b64")],
    "runs stored as they lie": [
        ("const int d = static_cast<int>(((row0 + k0) % kSector) * (frames % kSector) % kSector);", "const int d = 0;")
    ],
    "one run per stretch": [("for (int length = runs < 16 ? runs : 16; length <= runs; ++length) {", "for (int length = 1; length <= 1; ++length) {")],
}


# The copy that counts cycles: a tick after each phase of a run, summed per
# block in registers and written out by thread 0 when the block is done.
PHASES = ("wait for the slab", "barrier", "FFTs, twiddles, exchange", "barrier", "untangle, magnitude, barrier", "store loop")
_TICK = "{ const long long now = clock64(); spent[%d] += now - before; before = now; }\n"
PHASE_EDITS = [
    ("namespace {\n\nconstexpr int kNfft", "__device__ unsigned long long g_spent[6 * 1024];\n\nnamespace {\n\nconstexpr int kNfft"),
    (
        "  for (long long chunk = blockIdx.x; chunk < chunks; chunk += gridDim.x) {\n",
        "  unsigned long long spent[6] = {0, 0, 0, 0, 0, 0};\n  long long before = clock64();\n"
        "  for (long long chunk = blockIdx.x; chunk < chunks; chunk += gridDim.x) {\n",
    ),
    ("      __syncthreads();  // slab (and tables) ready", _TICK % 0 + "      __syncthreads();  // slab (and tables) ready"),
    ("      if (run + 1 < run_hi) {\n", _TICK % 1 + "      if (run + 1 < run_hi) {\n"),
    ("      __syncthreads();  // every warp is done with its plane", _TICK % 2 + "      __syncthreads();  // every warp is done with its plane"),
    ("      if (active) {\n        // Bins k = lane + 32*k2 < 512", _TICK % 3 + "      if (active) {\n        // Bins k = lane + 32*k2 < 512"),
    ("      __syncthreads();  // the tile is whole\n", "      __syncthreads();  // the tile is whole\n" + _TICK % 4),
    (
        "          dst += dst_step;\n        }\n      }\n",
        "          dst += dst_step;\n        }\n      }\n" + _TICK % 5,
    ),
    (
        "}\n\n}  // namespace\n",
        "  if (tid == 0 && blockIdx.x < 1024) {\n    for (int i = 0; i < 6; ++i) g_spent[6 * blockIdx.x + i] = spent[i];\n  }\n}\n\n}  // namespace\n\n"
        'extern "C" int stft_mag_read_spent(unsigned long long* host, int count) {\n'
        "  return static_cast<int>(cudaMemcpyFromSymbol(host, g_spent, count * sizeof(unsigned long long)));\n}\n",
    ),
]


def edited(edits: list) -> str:
    """``csrc/stft_mag.cu`` with every (old, new) of ``edits`` applied;
    each ``old`` must be there exactly once."""

    text = (cuda_build.CSRC / "stft_mag.cu").read_text()
    for old, new in edits:
        if text.count(old) != 1:
            raise RuntimeError(f"profile_stft edit: {old!r} is not in stft_mag.cu exactly once")
        text = text.replace(old, new)
    return text


def variant(name: str, edits: "list | None" = None) -> tuple[ctypes.CDLL, str]:
    """(library, compiler log) of the kernel with ``edits`` (default
    ``EDITS[name]``) applied."""

    text = edited(EDITS[name] if edits is None else edits)
    path, log = cuda_build.build_text("stft_mag_" + "_".join(name.split()), text)
    lib = ctypes.CDLL(str(path))
    lib.stft_mag_launch.argtypes = fused_stft.LAUNCH_ARGTYPES
    lib.stft_mag_launch.restype = ctypes.c_int
    return lib, log


def time_cuda_ms(fn, reps: int, warmup: int = 3) -> float:
    """Median milliseconds of ``fn`` on the card, CUDA events around each run."""

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--channels", type=int, nargs="+", default=[2, 8])
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()

    resolve_device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    libs = {}
    for name in EDITS:
        libs[name], log = variant(name)
        notes = [line.split(":")[-1].strip() for line in log.splitlines() if "registers" in line or "spill" in line]
        print(f"{name}: {'; '.join(notes) or '(cached build)'}")
    print(f"as built: {fused_stft.blocks_per_sm()} block(s) per SM")

    tables = fused_stft.fft_tables(N_FFT, "cuda")
    frames = 1 + BUCKET // HOP
    stream = torch.cuda.current_stream().cuda_stream
    for channels in args.channels:
        y = torch.randn((channels, BUCKET), device="cuda") * 0.3
        out = torch.empty((channels, 1 + N_FFT // 2, frames), device="cuda")

        def launch(lib):
            err = lib.stft_mag_launch(
                y.data_ptr(), tables.data_ptr(), out.data_ptr(), channels, BUCKET, N_FFT, HOP, N_FFT // 2, frames, stream
            )
            if err != 0:
                raise RuntimeError(f"stft_mag_launch failed: CUDA error {err}")

        for turn in range(2):  # every variant twice, in turns
            for name, lib in libs.items():
                ms = time_cuda_ms(lambda: launch(lib), args.reps)
                print(f"({channels}, {BUCKET}) {name}: {ms:.4f} ms -- {card}")
        print(
            f"({channels}, {BUCKET}) overwrite the output: {time_cuda_ms(out.zero_, args.reps):.4f} ms; "
            f"copy the input: {time_cuda_ms(y.clone, args.reps):.4f} ms -- {card}"
        )
        for name, edits in (("cycles", PHASE_EDITS), ("cycles no stores", PHASE_EDITS + EDITS["no stores"])):
            lib, _log = variant(name, edits)
            lib.stft_mag_read_spent.argtypes = [ctypes.c_void_p, ctypes.c_int]
            for _ in range(3):
                launch(lib)
            torch.cuda.synchronize()
            blocks = min(1024, torch.cuda.get_device_properties(0).multi_processor_count)
            spent = np.zeros(6 * blocks, dtype=np.uint64)
            err = lib.stft_mag_read_spent(spent.ctypes.data, spent.size)
            if err != 0:
                raise RuntimeError(f"stft_mag_read_spent failed: CUDA error {err}")
            runs = -(-frames // 16) * channels / blocks  # runs of 16 frames per block, if all blocks share evenly
            per_run = spent.reshape(blocks, 6).astype(np.float64).mean(axis=0) / runs
            shown = ", ".join(f"{phase} {cycles:.0f}" for phase, cycles in zip(PHASES, per_run))
            print(f"({channels}, {BUCKET}) {name}, SM cycles per run of 16 frames: {shown}; sum {per_run.sum():.0f} -- {card}")


if __name__ == "__main__":
    main()
