"""Where a warm analysis spends its time on a CUDA card, by the program's
own spans.

    python -m track_analyser_tpu_torch.profile_track [--seconds 181] [--reps 5] [--batch 1]

Synthesises bench.py's club-track recipe (118 BPM, seed 0) in memory and
runs the default path, ``analyse_library([audio] * batch,
device_batch=batch)`` (one chunk of ``--batch`` lanes: decode, staging,
upload, the fused graph, readback, the host finishers), once to warm it
up, then ``--reps`` times under ``torch.profiler``, which switches the
program's span recording on. Prints the span table: per span name, its
self time over the call (each span's wall minus what its children cover,
summed), median, min and max over the reps; then each run's device busy
share (the union of kernel, copy and memset intervals over the call's
wall), the last run's device time by kernel and the peak device memory.
With ``TA_PALLAS_STFT=1`` in the environment the graph's STFT is the fused
kernel, as everywhere in the port; the first line says which it was.
Prints the card's name and power limit beside the numbers. Needs a CUDA
card.
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import time
from collections import defaultdict

import numpy as np
import torch

from . import profiling
from .device import resolve_device
from .ops import fused_stft
from .parallel import batch
from .utils import AudioInput

def _make_track(seconds: float, sr: int = 44_100, bpm: float = 118.0, seed: int = 0) -> np.ndarray:
    """bench.py's _make_track recipe: kick grid + bass + chords + hats."""

    n = int(seconds * sr)
    t = np.arange(n, dtype=np.float64) / sr
    rng = np.random.default_rng(seed)
    beat = 60.0 / bpm
    kick = np.zeros(n)
    hat = np.zeros(n)
    for b in np.arange(0.0, seconds, beat):
        s = int(b * sr)
        e = min(n, s + int(0.08 * sr))
        seg = np.arange(e - s) / sr
        kick[s:e] += np.sin(2 * np.pi * (60 + 40 * np.exp(-seg * 60)) * seg) * np.exp(-seg * 30)
        hs = int((b + beat / 2) * sr)
        he = min(n, hs + int(0.02 * sr))
        if he > hs:
            hat[hs:he] += rng.normal(0, 0.15, he - hs) * np.exp(-np.arange(he - hs) / (0.004 * sr))
    bass = 0.2 * np.sin(2 * np.pi * 55.0 * t) * (np.sin(2 * np.pi * t / 8.0) > 0)
    chords = 0.1 * (
        np.sin(2 * np.pi * 220.0 * t) + np.sin(2 * np.pi * 277.18 * t) + np.sin(2 * np.pi * 329.63 * t)
    )
    left = 0.8 * kick + bass + chords + 0.6 * hat
    right = 0.8 * kick + bass + 0.9 * chords + 0.5 * hat
    peak = max(np.abs(left).max(), np.abs(right).max())
    return (np.stack([left, right]) / peak * 0.9).astype(np.float32)


def _union_ns(intervals) -> int:
    total, reach = 0, None
    for s, e in sorted(intervals):
        if reach is None or s > reach:
            total += e - s
            reach = e
        elif e > reach:
            total += e - reach
            reach = e
    return total


def self_times_ms(records) -> dict:
    """Self time (ms) per span name, summed over ``records``: each span's
    wall minus the union of its children's intervals inside it."""

    children = defaultdict(list)
    for r in records:
        if r.parent_id is not None:
            children[r.parent_id].append(r)
    out: dict = defaultdict(float)
    for r in records:
        inner = [(max(c.start_ns, r.start_ns), min(c.end_ns, r.end_ns)) for c in children[r.span_id]]
        covered = _union_ns((s, e) for s, e in inner if e > s)
        out[r.name] += (r.end_ns - r.start_ns - covered) / 1e6
    return dict(out)


def _profiled_call(audios: list, dev: torch.device, lanes: int):
    """One call under the profiler: (span records, wall ns, device
    intervals (ns), device ns by kernel name)."""

    profiling.reset_spans()
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.time_ns()
        batch.analyse_library(audios, device=dev, device_batch=lanes)
        torch.cuda.synchronize()
        t1 = time.time_ns()
    records = [r for r in profiling.spans() if r.start_ns >= t0 and r.end_ns <= t1]
    device, by_name = [], defaultdict(int)
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA and e.duration_ns() > 0:
            device.append((max(e.start_ns(), t0), min(e.end_ns(), t1)))
            by_name[e.name()] += e.duration_ns()
    return records, t1 - t0, device, by_name


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seconds", type=float, default=181.0)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--batch", type=int, default=1, help="lanes of the one chunk (device_batch)")
    args = ap.parse_args()

    dev = resolve_device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    route = "the fused kernel (TA_PALLAS_STFT=1)" if fused_stft.switched_on() else "cuFFT (ops/stft.magnitude)"
    print(f"the graph's [mid, side] STFT goes through {route}")
    x = _make_track(args.seconds)
    audios = [AudioInput(samples=x.mean(axis=0), sample_rate=44_100, stereo_samples=x)] * args.batch
    batch.analyse_library(audios, device=dev, device_batch=args.batch)  # warm-up
    runs = [_profiled_call(audios, dev, args.batch) for _ in range(args.reps)]

    tables = [self_times_ms(records) for records, *_ in runs]
    print(f"span self times, warm, batch {args.batch}, {args.seconds:g} s, over {args.reps} runs (ms) -- {card}")
    names = sorted({n for t in tables for n in t}, key=lambda n: -statistics.median(t.get(n, 0.0) for t in tables))
    for name in names:
        values = sorted(t.get(name, 0.0) for t in tables)
        print(f"  {name:18s} median {statistics.median(values):9.3f}  min {values[0]:9.3f}  max {values[-1]:9.3f}")
    walls = [wall / 1e6 for _r, wall, _d, _b in runs]
    print(f"  {'call wall':18s} median {statistics.median(walls):9.3f}  min {min(walls):9.3f}  max {max(walls):9.3f}")
    for k, (_records, wall, device, _by_name) in enumerate(runs):
        busy = _union_ns(device)
        print(f"run {k}: wall {wall / 1e6:.3f} ms, {len(device)} device kernels/copies, device busy "
              f"{busy / 1e6:.3f} ms ({100 * busy / wall:.1f}% of wall, union of intervals) -- {card}")
    by_name = runs[-1][3]
    print("device time by kernel, last run (top 25):")
    for name, ns in sorted(by_name.items(), key=lambda kv: -kv[1])[:25]:
        print(f"  {ns / 1e6:9.3f} ms  {name[:110]}")
    print(f"peak device memory allocated: {torch.cuda.max_memory_allocated() / 2**20:.0f} MiB -- {card}")


if __name__ == "__main__":
    main()
