"""Run length and block shape of the median31 kernel, timed on a CUDA card.

    python -m track_analyser_tpu_torch.profile_median [--reps 15] [--against FILE ...]

``csrc/median31.cu`` is built as it is and in edited copies, all at once
(one ``nvcc`` each), and every copy is held bit for bit to
``median31_reference`` and timed with CUDA events along both axes, in
turns, at the main path's shapes: one lane (1025, 16 385), a sweep batch
of four, the DSP separator's (2, 2049, 8193) and its shape for a 47 s song
at 22.05 kHz, (2049, 1025). The copies:

- ``r8``, ``r16``, ``r32``: the generated block for runs of 8, 16 or 32
  outputs a thread on both axes (``ops/median.cuda_block``);
- ``freq 64``, ``freq 256``: the frequency kernel's block of 64 or 256
  threads (built: 128);
- ``time 64``, ``time 256``: the time kernel's block of 2 or 8 warps
  (built: 4);
- ``time 6 per SM``, ``freq 5 per SM``, ``freq 6 per SM``: the register
  budget that lets 6 (or 5) blocks share an SM (``__launch_bounds__``'s
  second argument; built: none, ptxas picks);
- ``loads only``: no network, each output the largest of its window's
  first, centre and last input (2 max per output, every input read): the
  loads, staging and stores alone.

``--against FILE ...`` adds other sources of the same kernel as they are
(for example an earlier commit's ``median31.cu``, from ``git show``),
built and timed in the same turns. Each time is the median over
``--reps`` runs of 20 launches back to back, per launch. Beside each
copy: the min/max per output of its network, the ptxas registers and
spills, the SASS instructions of each kernel by opcode (``cuobjdump
-sass``: all, FMNMX, the loads and stores), and the card's name and power
limit. Needs a CUDA card and ``nvcc``; none of the copies is used outside
this script.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import statistics
import subprocess
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from .device import resolve_device
from .ops import cuda_build, median

SHAPES = ((1025, 16_385), (4, 1025, 16_385), (2, 2049, 8193), (2049, 1025))
_RUN_CALL = "Median31Net<R>::run(v, m);"
_BUILT_RUN = median.RUN_TIME
# name -> (run length, [(text in csrc/median31.cu, its replacement)])
VARIANTS = {
    "r8": (8, []),
    "r16": (16, []),
    "r32": (32, []),
    "freq 64": (_BUILT_RUN, [("constexpr int kFreqBlock = 128;", "constexpr int kFreqBlock = 64;")]),
    "freq 256": (_BUILT_RUN, [("constexpr int kFreqBlock = 128;", "constexpr int kFreqBlock = 256;")]),
    "time 64": (_BUILT_RUN, [("constexpr int kTimeBlock = 128;", "constexpr int kTimeBlock = 64;")]),
    "time 256": (_BUILT_RUN, [("constexpr int kTimeBlock = 128;", "constexpr int kTimeBlock = 256;")]),
    "time 6 per SM": (_BUILT_RUN, [("__launch_bounds__(kTimeBlock)", "__launch_bounds__(kTimeBlock, 6)")]),
    "freq 5 per SM": (_BUILT_RUN, [("__launch_bounds__(kFreqBlock)", "__launch_bounds__(kFreqBlock, 5)")]),
    "freq 6 per SM": (_BUILT_RUN, [("__launch_bounds__(kFreqBlock)", "__launch_bounds__(kFreqBlock, 6)")]),
    "loads only": (_BUILT_RUN, [(_RUN_CALL, "for (int j = 0; j < R; ++j) m[j] = fmaxf(fmaxf(v[j], v[j + kRadius]), v[j + 2 * kRadius]);")]),
}


def edited(run: int, edits: list) -> str:
    """``csrc/median31.cu`` with the generated block for runs of ``run``
    on both axes and every (old, new) of ``edits`` applied to all its
    places; each ``old`` must be there."""

    text = (cuda_build.CSRC / "median31.cu").read_text()
    text = text.replace(median.source_block(text), median.cuda_block((run, run)))
    for old, new in edits:
        if old not in text:
            raise RuntimeError(f"profile_median edit: {old!r} is not in median31.cu")
        text = text.replace(old, new)
    return text


def sass_counts(lib_path: Path) -> "dict[str, Counter]":
    """Instructions of each kernel in the library's SASS, by opcode
    (``cuobjdump -sass``); {} where the toolkit has no ``cuobjdump``."""

    tool = Path(cuda_build.nvcc()).with_name("cuobjdump")
    if not tool.exists():
        return {}
    listing = subprocess.run([str(tool), "-sass", str(lib_path)], capture_output=True, text=True, check=True).stdout
    counts: dict = {}
    kernel = None
    for line in listing.splitlines():
        function = re.search(r"Function : (\S+)", line)
        if function:
            name = function.group(1)  # an earlier kernel was one template: <true> along time
            kernel = "time" if "median31_kernel_time" in name or "ILb1E" in name else "freq"
            counts[kernel] = Counter()
            continue
        op = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", line)
        if op and kernel:
            counts[kernel][op.group(1)] += 1
    return counts


def build(name: str, text: "str | None" = None) -> tuple[ctypes.CDLL, str]:
    """(library, ptxas registers and spills, SASS counts) of variant
    ``name``, or of source ``text`` as it is."""

    if text is None:
        text = edited(*VARIANTS[name])
    path, log = cuda_build.build_text("median31_" + "_".join(name.split()), text)
    lib = ctypes.CDLL(str(path))
    lib.median31_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.median31_launch.restype = ctypes.c_int
    notes = [line.split("ptxas info    :")[-1].strip() for line in log.splitlines() if "registers" in line or "spill" in line]
    sass = "; ".join(
        f"{kernel}: {sum(ops.values())} instructions, "
        + ", ".join(f"{op} {ops[op]}" for op in ("FMNMX", "LDG", "LDS", "STS", "STG", "WARPSYNC", "BAR"))
        for kernel, ops in sass_counts(path).items()
    )
    return lib, "; ".join(notes) + (f"\n    SASS {sass}" if sass else "")


def time_cuda_ms(fn, reps: int, warmup: int = 3, launches: int = 20) -> float:
    """Median milliseconds of one call of ``fn`` on the card: CUDA events
    around ``launches`` calls back to back, so that no launch gap counts."""

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(launches):
            fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / launches)
    return statistics.median(times)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=15)
    ap.add_argument("--against", type=Path, nargs="+", default=[], help="other median31.cu sources, built and timed as they are")
    args = ap.parse_args()

    resolve_device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    jobs = {name: (name, None) for name in VARIANTS}
    for path in args.against:
        jobs[f"against {path.name}"] = (f"against {path.stem}", path.read_text())
    with ThreadPoolExecutor(max_workers=len(jobs)) as pool:
        built = dict(zip(jobs, pool.map(lambda job: build(*job), jobs.values())))
    for name, (_lib, notes) in built.items():  # ptxas lists the kernels in its own order
        if name in VARIANTS:
            run = VARIANTS[name][0]
            print(f"{name}: runs of {run}, {median.tile_network(run).per_output:g} min/max per output; {notes}")
        else:
            print(f"{name}: {notes}")

    gen = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    for shape in SHAPES:
        x = torch.rand(shape, device="cuda", generator=gen)
        out = torch.empty_like(x)
        rows, cols = shape[-2:]
        batch = shape[0] if len(shape) == 3 else 1
        for axis in (-1, -2):

            def launch(lib):
                err = lib.median31_launch(x.data_ptr(), out.data_ptr(), batch, rows, cols, int(axis == -1), stream)
                if err != 0:
                    raise RuntimeError(f"median31_launch failed: CUDA error {err}")

            ref = median.median31_reference(x, axis)
            for name, (lib, _notes) in built.items():
                launch(lib)
                torch.cuda.synchronize()
                if name != "loads only" and not torch.equal(out, ref):
                    raise RuntimeError(f"{name} at {shape} axis {axis}: not bit-identical to median31_reference")
            del ref
            times = {name: [] for name in built}
            for turn in (list(built), list(reversed(built))):  # in turns, forwards then back
                for name in turn:
                    times[name].append(time_cuda_ms(lambda: launch(built[name][0]), args.reps))
            for name, ms in times.items():
                print(f"{shape} axis {axis} {name}: {' / '.join(f'{t:.4f}' for t in ms)} ms -- {card}")
        del x, out


if __name__ == "__main__":
    main()
