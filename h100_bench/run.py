"""Run one cell of the benchmark and print its result as the last line.

    python -m h100_bench.run --workload single-cd44k --seed 7 --seconds 10 --trace 0

Exits non-zero, printing no result, without CUDA or with fewer cards
than the cell asks for, and when a forbidden module (the JAX package,
``jax``, ``jaxlib``, ``flax``) is loaded once the window has closed.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# Every build and kernel cache at a fixed path inside the checkout.
for var, sub in (
    ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
    ("TRITON_CACHE_DIR", "triton"),
    ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
    ("CUDA_CACHE_PATH", "cuda_jit"),
):
    os.environ[var] = str(ROOT / "build" / "h100_bench" / sub)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--save-trace", type=Path, default=None, help="write the traced stretch here as JSON")
    args = ap.parse_args(argv)

    from .harness import forbidden_modules, run_cell
    from .spec import Spec

    spec = Spec(ROOT)
    cell = spec.cell(args.workload)

    def check_device(torch) -> None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < cell.chips:
            raise SystemExit(f"{cell.name} needs {cell.chips} CUDA card(s); {have} visible")

    result = run_cell(spec, cell, seed=args.seed, seconds=args.seconds, trace=bool(args.trace), t0=T0,
                      save_trace=args.save_trace, check_device=check_device)
    found = forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {found}", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
