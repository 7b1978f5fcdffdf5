"""Smoke run of the PyTorch port on one CUDA card: build, check, time.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):
  1. environment: torch / CUDA versions, the card, its power limit, nvcc;
  2. build the median31 CUDA kernel from csrc/ (nvcc, sm_90a);
  3. the kernel against its plain PyTorch version on the card, along both
     axes, at the main path's shape and at ragged and batched shapes
     (bit-identical), and both timed with CUDA events;
  4. the main path: analyse_track(path, device="cuda") on a synthetic
     181 s 44.1 kHz stereo WAV (bench.py's asserted fixture: 118 BPM,
     seed 0), cold and warm; the median launch counts must rise by
     exactly 2 per call, the BPM must be 118 +- 0.1 and every numeric
     field finite;
  5. the same 30 s excerpt (with a noise floor) analysed with
     device="cuda" and device="cpu": every TrackAnalysisResult field must
     agree within the CPU parity tests' tolerances.
The last two lines before the result are the kernels' JSON record and the
card's name and power limit; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

Imports nothing of JAX: it drives the port only.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

# bench.py's first, asserted fixture. (Its default 126-BPM recipe reads
# 126.13 with the reference tempo estimator, on the card and on the CPU
# alike: a bias of the estimator on that fixture, not of the device.)
BPM = 118.0
SEED = 0
SECONDS = 181.0
SR = 44_100
MAIN_SHAPE = (1025, 16_385)  # |STFT| of a 3-minute track's 8,388,608-sample bucket
KERNEL_SOURCE = "track_analyser_tpu_torch/csrc/median31.cu"
REPLACES = {
    -1: ("median31_time", "track_analyser_tpu/ops/pallas_median.py:82"),
    -2: ("median31_freq", "track_analyser_tpu/ops/pallas_median.py:115"),
}


def fail(message: str) -> None:
    print(f"chip_smoke: FAILED: {message}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def check(condition: bool, message: str) -> None:
    if not condition:
        fail(message)


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def make_track(seconds: float, sr: int = SR, bpm: float = BPM, seed: int = SEED) -> np.ndarray:
    """Club-style stereo track (kick grid + bass + chords + hats), the
    recipe of bench.py's _make_track; returns float32 (2, n)."""

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


def time_cuda_ms(fn, reps: int = 15, warmup: int = 3) -> float:
    """Median milliseconds of ``fn`` on the card, CUDA events around each run."""

    import torch

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


def numeric_leaves(obj, prefix: str = "result"):
    """(name, value) for every number and array inside a result dataclass."""

    if isinstance(obj, (bool, str)) or obj is None:
        return
    if isinstance(obj, (int, float, np.floating, np.integer)):
        yield prefix, float(obj)
    elif isinstance(obj, np.ndarray):
        if obj.dtype.kind in "fiu":
            yield prefix, obj
    elif isinstance(obj, dict):
        for key, value in obj.items():
            yield from numeric_leaves(value, f"{prefix}.{key}")
    elif isinstance(obj, (list, tuple)):
        for i, value in enumerate(obj):
            yield from numeric_leaves(value, f"{prefix}[{i}]")
    elif hasattr(obj, "__dataclass_fields__"):
        for key in obj.__dataclass_fields__:
            yield from numeric_leaves(getattr(obj, key), f"{prefix}.{key}")


def compare_results(got, ref) -> None:
    """Every TrackAnalysisResult field within the CPU parity tests'
    tolerances (tests/test_torch_pipeline.py)."""

    def close(a, b, atol, what, rtol=0.0):
        a, b = np.asarray(a, dtype=float), np.asarray(b, dtype=float)
        check(a.shape == b.shape, f"{what}: shape {a.shape} vs {b.shape}")
        err = float(np.max(np.abs(a - b))) if a.size else 0.0
        ok = np.allclose(a, b, rtol=rtol, atol=atol)
        check(ok, f"{what}: max |diff| {err} beyond atol {atol} rtol {rtol}")
        return err

    worst = {}
    worst["bpm"] = close(got.beat.bpm, ref.beat.bpm, 1e-3, "bpm")
    close(got.beat.confidence, ref.beat.confidence, 1e-3, "beat confidence")
    worst["beat_times"] = close(got.beat.beat_times, ref.beat.beat_times, 1e-4, "beat times")
    worst["tracked_times"] = close(got.beat.tracked_times, ref.beat.tracked_times, 0.012, "tracked beats")
    check(got.downbeat.source == ref.downbeat.source, "downbeat source")
    worst["downbeat_times"] = close(
        got.downbeat.downbeat_times, ref.downbeat.downbeat_times, 1e-4, "downbeat times"
    )
    check(got.downbeat.beat_positions == ref.downbeat.beat_positions, "beat positions")
    gs, rs = got.structure.segments, ref.structure.segments
    check(len(gs) == len(rs), f"section count {len(gs)} vs {len(rs)}")
    check([s.label for s in gs] == [s.label for s in rs], "section labels")
    check([s.category for s in gs] == [s.category for s in rs], "section categories")
    close([s.start for s in gs], [s.start for s in rs], 1e-3, "section starts")
    close([s.end for s in gs], [s.end for s in rs], 1e-3, "section ends")
    for attr in ("integrated_lufs", "loudness_range", "true_peak_dbfs", "rms_dbfs"):
        worst[attr] = close(getattr(got.loudness, attr), getattr(ref.loudness, attr), 5e-3, attr)
    worst["momentary"] = close(got.loudness.momentary_lufs, ref.loudness.momentary_lufs, 2e-2, "momentary")
    worst["short_term"] = close(got.loudness.short_term_lufs, ref.loudness.short_term_lufs, 2e-2, "short-term")
    gh, rh = got.harmonic, ref.harmonic
    check(gh.primary_key.key == rh.primary_key.key, "primary key")
    check(gh.secondary_key.key == rh.secondary_key.key, "secondary key")
    close(gh.primary_key.confidence, rh.primary_key.confidence, 1e-3, "key confidence")
    check([h.chord for h in gh.chord_hints] == [h.chord for h in rh.chord_hints], "chord hints")
    close([p.time for p in gh.chord_change_points], [p.time for p in rh.chord_change_points], 1e-4, "chord changes")
    close(
        [p.strength for p in gh.chord_change_points],
        [p.strength for p in rh.chord_change_points],
        1e-2,
        "chord change strengths",
    )
    for band in ("low_band", "mid_band", "high_band"):
        close(getattr(gh.spectral_balance, band), getattr(rh.spectral_balance, band), 1e-3, band)
    close(gh.stereo_image.correlation, rh.stereo_image.correlation, 1e-3, "stereo image correlation")
    close(gh.stereo_image.balance, rh.stereo_image.balance, 1e-3, "stereo image balance")
    for attr in ("hook_suggestion", "bass_suggestion"):
        for column in ("pitch", "velocity"):
            check(
                getattr(gh, attr).notes[column].tolist() == getattr(rh, attr).notes[column].tolist(),
                f"{attr} {column}",
            )
    close(got.features.ltas.magnitude, ref.features.ltas.magnitude, 1e-3, "ltas", rtol=1e-3)
    close(got.features.spectral_centroid.values, ref.features.spectral_centroid.values, 0.0, "centroid", rtol=1e-3)
    close(got.features.spectral_centroid.mean, ref.features.spectral_centroid.mean, 0.0, "centroid mean", rtol=1e-3)
    # rolloff is a bin frequency, shipped at f16: a frame whose cumulative
    # sum sits on the 85% threshold may land one bin away, plus one f16 step
    bin_hz = got.audio.sample_rate / 2048
    close(got.features.spectral_rolloff.values, ref.features.spectral_rolloff.values, bin_hz, "rolloff", rtol=1e-3)
    close(got.features.spectral_rolloff.mean, ref.features.spectral_rolloff.mean, 0.0, "rolloff mean", rtol=1e-3)
    close(got.stereo.mid_rms, ref.stereo.mid_rms, 1e-4, "mid rms")
    close(got.stereo.side_rms, ref.stereo.side_rms, 1e-4, "side rms")
    close(got.stereo.correlation, ref.stereo.correlation, 1e-3, "stereo correlation")
    for band in ("low", "mid", "high"):
        close(getattr(got.stereo.width, band), getattr(ref.stereo.width, band), 1e-2, f"width {band}")
    print("gpu vs cpu worst |diff|:", json.dumps({k: float(v) for k, v in worst.items()}), flush=True)


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a CUDA card")

    from track_analyser_tpu_torch import analyse_track
    from track_analyser_tpu_torch.io import write_wav
    from track_analyser_tpu_torch.ops import median
    from track_analyser_tpu_torch.utils import AudioInput, coerce_audio

    # ---- 1. environment ----------------------------------------------------
    phase("1 environment")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    card = f"{smi} (nvidia-smi name, power.limit)"
    nvcc = subprocess.run([median._nvcc(), "--version"], capture_output=True, text=True, check=True)
    print("python", sys.version.split()[0], "| torch", torch.__version__, "| torch.version.cuda", torch.version.cuda)
    print("device", torch.cuda.get_device_name(0), "| count", torch.cuda.device_count())
    print("card:", card)
    print("nvcc:", nvcc.stdout.strip().splitlines()[-1])
    for module in ("triton", "pandas"):
        try:
            __import__(module)
            print(f"{module}: imports")
        except ImportError:
            print(f"{module}: not installed")

    # ---- 2. build ----------------------------------------------------------
    phase("2 build")
    t0 = time.perf_counter()
    lib_path, log = median.build()
    print(f"built {lib_path.name} in {time.perf_counter() - t0:.2f} s")
    print(log.strip() or "(cached)")

    # ---- 3. kernel vs plain on the card --------------------------------------
    phase("3 median31 kernel vs plain PyTorch on the card")
    gen = torch.Generator(device="cuda").manual_seed(0)
    errs = {}
    for shape in (MAIN_SHAPE, (33, 513), (1025, 65), (2, 1025, 4097)):
        x = torch.rand(shape, device="cuda", generator=gen)
        for axis in (-1, -2):
            got = median.median31(x, axis)
            ref = median.median31_reference(x, axis)
            torch.cuda.synchronize()
            err = float((got - ref).abs().max())
            errs[axis] = max(errs.get(axis, 0.0), err)
            check(torch.equal(got, ref), f"median31 axis {axis} shape {shape}: max |diff| {err}")
            print(f"shape {shape} axis {axis}: bit-identical")
    x = torch.rand(MAIN_SHAPE, device="cuda", generator=gen)
    timings = {}
    for axis in (-1, -2):
        kernel_ms = time_cuda_ms(lambda: median.median31(x, axis))
        plain_ms = time_cuda_ms(lambda: median.median31_reference(x, axis), reps=10, warmup=2)
        timings[axis] = (kernel_ms, plain_ms)
        name = REPLACES[axis][0]
        gbps = 2 * x.numel() * 4 / (kernel_ms * 1e-3) / 1e9
        print(
            f"{name} at {MAIN_SHAPE}: kernel {kernel_ms:.4f} ms ({gbps:.0f} GB/s of one read + one write), "
            f"plain {plain_ms:.4f} ms -- {card}"
        )

    # ---- 4. main path ----------------------------------------------------
    phase("4 main path: analyse_track on a 181 s WAV")
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "track_181s.wav"
        write_wav(path, make_track(SECONDS), SR)
        median.median31.launches = 0
        median.median31.launches_time = 0
        median.median31.launches_freq = 0
        results, walls = [], []
        torch.cuda.reset_peak_memory_stats()
        for label in ("cold", "warm"):
            before = (median.median31.launches_time, median.median31.launches_freq)
            t0 = time.perf_counter()
            result = analyse_track(str(path), device="cuda")
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            after = (median.median31.launches_time, median.median31.launches_freq)
            check(
                after == (before[0] + 1, before[1] + 1),
                f"{label} run: median launches (time, freq) went {before} -> {after}, expected +1 each",
            )
            results.append(result)
            print(f"{label} analyse_track: {walls[-1] * 1e3:.1f} ms wall -- {card}")
        launches = {-1: median.median31.launches_time, -2: median.median31.launches_freq}
        peak_mb = torch.cuda.max_memory_allocated() / 2**20
        t0 = time.perf_counter()
        audio = coerce_audio(str(path))
        decode_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        analyse_track(audio, device="cuda")
        torch.cuda.synchronize()
        preloaded_ms = (time.perf_counter() - t0) * 1e3
    print(
        f"warm split: WAV decode {decode_ms:.1f} ms; analyse_track on the decoded "
        f"AudioInput {preloaded_ms:.1f} ms -- {card}"
    )
    print(f"median31 launches over the two calls: time {launches[-1]}, freq {launches[-2]}")
    print(f"peak device memory allocated: {peak_mb:.0f} MiB")
    result = results[-1]
    print(
        f"bpm {result.beat.bpm:.4f} | beats {len(result.beat.beat_times)} | downbeat source "
        f"{result.downbeat.source} | key {result.harmonic.primary_key.key} | sections "
        f"{len(result.structure.segments)} | LUFS {result.loudness.integrated_lufs:.3f} | "
        f"true peak {result.loudness.true_peak_dbfs:.3f} dBFS"
    )
    check(abs(result.beat.bpm - BPM) <= 0.1, f"bpm {result.beat.bpm} not within 0.1 of {BPM}")
    leaves = list(numeric_leaves(result))
    check(len(leaves) > 20, "result has too few numeric fields")
    for name, value in leaves:
        check(bool(np.all(np.isfinite(value))), f"{name} is not finite")
    print(f"{len(leaves)} numeric fields, all finite")

    # ---- 5. GPU vs CPU inside the port ----------------------------------------
    phase("5 GPU vs CPU on a 30 s excerpt")
    # A -50 dBFS noise floor keeps the finishers' decisions on the signal:
    # on noise-free synthetic tones the onset envelope between hits is
    # float rounding noise, and onset backtracking would pick its minima
    # from the two devices' different rounding.
    excerpt = make_track(30.0, bpm=126.0, seed=11)
    excerpt = excerpt + np.random.default_rng(5).normal(0.0, 0.003, excerpt.shape).astype(np.float32)
    audio = AudioInput(samples=excerpt.mean(axis=0), sample_rate=SR, stereo_samples=excerpt)
    on_gpu = analyse_track(audio, device="cuda")
    on_cpu = analyse_track(audio, device="cpu")
    compare_results(on_gpu, on_cpu)
    print("gpu and cpu results agree on every field")

    record = {
        "kernels": [
            {
                "name": REPLACES[axis][0],
                "route": "cuda",
                "source": KERNEL_SOURCE,
                "replaces": REPLACES[axis][1],
                "launches": launches[axis],
                "max_abs_err": errs[axis],
                "ms": timings[axis][0],
                "plain_ms": timings[axis][1],
            }
            for axis in (-1, -2)
        ]
    }
    print(json.dumps(record))
    print(smi)
    print(
        json.dumps(
            {
                "ok": True,
                "device": {
                    "platform": "gpu",
                    "kind": torch.cuda.get_device_name(0),
                    "count": torch.cuda.device_count(),
                },
            }
        ),
        flush=True,
    )


if __name__ == "__main__":
    main()
