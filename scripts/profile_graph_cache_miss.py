"""What a miss in the fused graph's cache costs a call on a CUDA card.

    python scripts/profile_graph_cache_miss.py [--reps 3]

A card keeps the captured graphs of eight buckets (``parallel.batch``,
least recently used evicted). A library of nine or more buckets, called
one track at a time in cycles, misses on every call: each runs its graph
eagerly and captures it again. This writes nine synthetic stereo tracks
(``profile_track``'s club recipe) in nine distinct buckets of the "ms"
transport: seven of 14-31.5 s and two full-length songs of 240 and 300 s.
For plain calls and for ``use_stems=True`` calls in turn, it warms every
track, then cycles ``--reps`` times over the first eight (every call
replays: a hit) and ``--reps`` times over all nine (every call captures:
a miss), timing each call and reading its ``graph_capture`` and
``graph_replay`` seconds from ``profiling.stage_seconds()``. Prints a
JSON line per track and kind (medians of the hits and the misses, and
their difference) with the card's name and power limit, and the device
memory peak. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from track_analyser_tpu_torch import analyse_track, profiling  # noqa: E402
from track_analyser_tpu_torch.io import write_wav  # noqa: E402
from track_analyser_tpu_torch.parallel import batch  # noqa: E402
from track_analyser_tpu_torch.profile_track import _make_track  # noqa: E402

SR = 44_100
SECONDS = (14.0, 16.0, 18.5, 21.0, 24.0, 27.5, 31.5, 240.0, 300.0)


def _call(path: str, stems: bool) -> dict:
    before = profiling.stage_seconds()
    t0 = time.perf_counter()
    analyse_track(path, use_stems=stems, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    after = profiling.stage_seconds()
    delta = {k: after.get(k, 0.0) - before.get(k, 0.0) for k in ("graph_capture", "graph_replay")}
    return {"wall_s": wall, **delta}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    work = Path(tempfile.mkdtemp(prefix="graph_cache_miss_"))
    paths = []
    for i, seconds in enumerate(SECONDS):
        x = _make_track(seconds, sr=SR, seed=i)
        path = work / f"track_{i}.wav"
        write_wav(path, x, SR)
        paths.append(str(path))
    buckets = [batch.ms_bucket_length(int(s * SR)) for s in SECONDS]
    assert len(set(buckets)) == len(buckets) == batch._GRAPHS_PER_DEVICE + 1, buckets
    os.chdir(work)  # the stems go to ./stems/
    for stems in (False, True):
        batch.clear_graphs()
        for p in paths:  # warm: every separator shape and cuFFT plan, once
            _call(p, stems)
        hits = {p: [] for p in paths[:-1]}
        misses = {p: [] for p in paths}
        for _ in range(2):  # the first eight now replay
            for p in paths[:-1]:
                _call(p, stems)
        for _ in range(args.reps):
            for p in paths[:-1]:
                hits[p].append(_call(p, stems))
        for _ in range(args.reps + 1):
            for p in paths:
                misses[p].append(_call(p, stems))
        for i, p in enumerate(paths[:-1]):
            miss = misses[p][1:]  # the first cycle over nine still finds some graphs
            assert all(m["graph_capture"] > 0 for m in miss) and all(h["graph_capture"] == 0 for h in hits[p])
            hit_s = statistics.median(h["wall_s"] for h in hits[p])
            miss_s = statistics.median(m["wall_s"] for m in miss)
            print(json.dumps({
                "card": card, "stems": stems, "seconds": SECONDS[i], "bucket": buckets[i],
                "hit_ms": hit_s * 1e3, "miss_ms": miss_s * 1e3, "miss_minus_hit_ms": (miss_s - hit_s) * 1e3,
                "graph_capture_ms": statistics.median(m["graph_capture"] for m in miss) * 1e3,
                "graph_replay_ms": statistics.median(h["graph_replay"] for h in hits[p]) * 1e3,
            }), flush=True)
    print(json.dumps({"card": card, "memory_peak_bytes": int(torch.cuda.max_memory_allocated()),
                      "memory_reserved_bytes": int(torch.cuda.memory_reserved())}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
