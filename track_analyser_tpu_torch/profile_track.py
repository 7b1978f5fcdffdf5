"""Where a warm single-track analysis spends its time on a CUDA card.

    python -m track_analyser_tpu_torch.profile_track [--seconds 181] [--reps 5] [--batch 1]

Synthesises bench.py's club-track recipe (118 BPM, seed 0) in memory,
warms the path up, then times each layer of the float32 fused path with
the host clock around synchronised steps (median of ``--reps``): pad,
upload, fused graph (device), readback, unpack, host finishers. The
graph runs on ``--batch`` copies of the track as one batch (the sweep's
``device_batch``); pad, upload and readback move the whole batch, and the
finishers run on one lane. One more fused-graph run under
``torch.profiler`` gives the device time by kernel and the device's busy
share of that run, and the peak device memory of the whole script.
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

import numpy as np
import torch

from .device import resolve_device
from .ops import fused_stft
from .parallel import batch
from .substrate import bucket_length, unpack_outputs
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


def _padded_batch(audio: AudioInput, lanes: int) -> tuple[np.ndarray, np.ndarray]:
    """(lanes, 2, bucket) float32 copies of the track and their n_valid."""

    stereo_np, n_valid = batch._pad_track(audio, bucket_length(len(audio.samples)))
    return np.repeat(stereo_np[None], lanes, axis=0), np.full(lanes, n_valid, dtype=np.int64)


def _stages(audio: AudioInput, dev: torch.device, lanes: int) -> dict:
    """One warm pass of the float32 fused path on ``lanes`` copies of the
    track, timed layer by layer (ms)."""

    ms = {}
    t0 = time.perf_counter()
    stereo_np, n_valid = _padded_batch(audio, lanes)
    ms["pad"] = time.perf_counter() - t0
    with torch.inference_mode():
        t0 = time.perf_counter()
        stereo = torch.from_numpy(stereo_np).to(dev)
        valid = torch.from_numpy(n_valid).to(dev)
        torch.cuda.synchronize()
        ms["upload"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        outs = batch._core_graph(stereo, valid, sr=audio.sample_rate)
        torch.cuda.synchronize()
        ms["fused_graph"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        fetched = [o.cpu().numpy() for o in outs]
        ms["readback"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = unpack_outputs(*(f[0] for f in fetched[:4]))
    out["net_prob"] = fetched[4][0] if len(fetched) > 4 else None
    ms["unpack"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    batch.result_from_graph_outputs(audio, out)
    ms["finishers"] = time.perf_counter() - t0
    return {k: v * 1e3 for k, v in ms.items()}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seconds", type=float, default=181.0)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--batch", type=int, default=1, help="lanes per graph run")
    args = ap.parse_args()

    dev = resolve_device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    route = "the fused kernel (TA_PALLAS_STFT=1)" if fused_stft.switched_on() else "cuFFT (ops/stft.magnitude)"
    print(f"the graph's [mid, side] STFT goes through {route}")
    x = _make_track(args.seconds)
    audio = AudioInput(samples=x.mean(axis=0), sample_rate=44_100, stereo_samples=x)
    _stages(audio, dev, args.batch)  # warm-up: cuFFT plans, handles, allocator
    runs = [_stages(audio, dev, args.batch) for _ in range(args.reps)]
    print(f"layer times, warm, batch {args.batch}, median of {args.reps} (ms) -- {card}")
    total = 0.0
    for key in runs[0]:
        values = sorted(r[key] for r in runs)
        total += statistics.median(values)
        print(f"  {key:12s} median {statistics.median(values):9.3f}  min {values[0]:9.3f}  max {values[-1]:9.3f}")
    print(f"  {'sum':12s} {total:9.3f}")

    stereo_np, n_valid = _padded_batch(audio, args.batch)
    with torch.inference_mode():
        stereo = torch.from_numpy(stereo_np).to(dev)
        valid = torch.from_numpy(n_valid).to(dev)
        torch.cuda.synchronize()
        activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=activities) as prof:
            t0 = time.perf_counter()
            batch._core_graph(stereo, valid, sr=audio.sample_rate)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [
        e for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA and e.device_time_total > 0
    ]
    busy_ms = sum(e.device_time_total for e in kernels) / 1e3
    print(
        f"fused graph (batch {args.batch}) under the profiler: wall {wall_ms:.3f} ms, {len(kernels)} device "
        f"kernels/copies, device busy {busy_ms:.3f} ms ({100 * busy_ms / wall_ms:.1f}% of wall) -- {card}"
    )
    by_name: dict = {}
    for e in kernels:
        total_us, count = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (total_us + e.device_time_total, count + 1)
    print("device time by kernel (top 25):")
    for name, (us, count) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:25]:
        print(f"  {us / 1e3:9.3f} ms  x{count:<4d} {name[:110]}")
    print(f"peak device memory allocated: {torch.cuda.max_memory_allocated() / 2**20:.0f} MiB -- {card}")


if __name__ == "__main__":
    main()
