"""The readings the limits of ``correct`` are set from, for one cell.

    python -m h100_bench.calibrate --workload single-cd44k --seeds 1 2 3 --control-seeds 1 2 3

For each seed, in one process: the corpus, one traced-stretch's worth of
the cell's traffic through the program (a cycle of the corpus, or one
sweep call), the plain references (the analysis and those the
configuration names), and, for the control seeds, each reference again
with ``control=True`` (the analysis in float32 with TF32, the precision
below the configuration's float32 with TF32 off) in the program's place.
Prints one JSON line a seed with every compared number of the program
(the lower readings) and of the control (the upper readings), each with
the leaf where it lies, the same numbers for each reference alone, and
the worst gap of every compared leaf of each reference, all from one
comparison.
Not part of a benchmark run.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
import time
from pathlib import Path

from .drive import Driver
from .gen import corpus
from .harness import _reference, bucket_of, compare
from .spec import Spec

ROOT = Path(__file__).resolve().parents[1]


def _sides(side: str, numbers) -> dict:
    """One side's numbers: over every reference, by reference, and by leaf."""

    return {side: numbers.worst, f"{side}_by_reference": numbers.by_reference, f"{side}_fields": numbers.fields}


def readings(spec: Spec, cell_name: str, seed: int, control: bool, device: str = "cuda") -> dict:
    cell = spec.cell(cell_name)
    references = spec.references(cell)
    work = Path(tempfile.mkdtemp(prefix=f"h100_bench_cal_{cell.name}_"))
    try:
        t0 = time.perf_counter()
        tracks = corpus.build(cell.config, seed, work)
        driver = Driver(cell.traffic, cell.config, tracks, seed, device, work)
        driver.warm(bucket_of)
        served = [o for o in driver.stretch() if o.error is None]
        t_ref = time.perf_counter()
        refs = _reference(tracks, [o.track for o in served], device, tf32=False, references=references)
        program = compare(served, refs, tracks, references)
        line = {"cell": cell.name, "seed": seed, "served": len(served),
                "reference_s": time.perf_counter() - t_ref, **_sides("program", program)}
        if control:
            ctl = _reference(tracks, sorted(refs), device, tf32=True, references=references)
            line.update(_sides("control", compare(served, refs, tracks, references, answers=ctl)))
        line["seconds"] = time.perf_counter() - t0
        return line
    finally:
        shutil.rmtree(work, ignore_errors=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)
    spec = Spec(ROOT)
    for seed in args.seeds:
        print(json.dumps(readings(spec, args.workload, seed, seed in args.control_seeds)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
