"""Smoke run of the PyTorch port on one CUDA card: build, check, time.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):
  1. environment: torch / CUDA versions, the card, its power limit and
     clock, nvcc, the host CPU;
  2. build both CUDA kernels from csrc/ (one nvcc each) and the native host
     libraries (libta_native, and libta_ffmpeg where the libav* headers
     are; g++), all started together, each with its build seconds; a
     failed libta_native build fails the run;
  3. the median31 kernel against its plain PyTorch version on the card,
     along both axes, at the main paths' shapes (one lane and a batch of
     four lanes), at ragged shapes and at axes shorter than the window
     ((7, 20), (40, 9), (1, 5)), on uniform and on tie-heavy values (8
     levels with exact zeros), bit-identical; its run length and min/max
     per output as the port's generator reports them; all timed with CUDA
     events beside both bounds (bytes; the network's min/max) and beside
     the library call (one unchunked unfold + median over a reflect-padded
     copy, bit-identical too);
  4. the single-track path: analyse_track(path, device="cuda") on a
     synthetic 181 s 44.1 kHz stereo WAV (bench.py's asserted fixture: 118
     BPM, seed 0) with transport "auto" (= "ms"), cold and warm; the median
     launches must rise by exactly 1 per axis per call and the fused STFT
     must not launch; the BPM must be 118 +- 0.1 and every numeric field
     finite; the warm wall time under "float32" beside it;
  5. the same 30 s excerpt (with a noise floor) analysed with
     device="cuda" and device="cpu": every TrackAnalysisResult field must
     agree within the CPU parity tests' tolerances (bar positions exactly,
     or on a proven exact tie of the decoder);
  6. the fused |STFT| kernel against its plain version and against the
     cuFFT path (ops/stft.magnitude) at the sweep's shapes, at ragged ones
     (shorter than a frame, no hop multiple at 8 channels, a strided
     input), on an impulse and on a pure tone, within 2e-6 of each frame's
     norm, all three timed with CUDA events beside the bound (the bytes of
     the signal and the magnitudes, whatever computes them);
  7. the library sweep: analyse_library over a small WAV library (181 s,
     150 s mono, 120 s and 30 s tracks, one file that does not decode)
     with transport "ms" and device_batch 4, once with TA_PALLAS_STFT=1
     (the fused STFT kernel) and once without (cuFFT), with the peak device
     memory of each. Checks the outcome
     per source, the launch counts per chunk, the 118-BPM track, every
     track against a batch-1 analyse_track and the two sweeps against each
     other, the manifest's resume; then times warm sweeps at device_batch
     1 and 4 over a 40-source library (the five WAVs linked eight times),
     three runs each, with quartiles and the stage times per track;
  8. the median31 kernel at the DSP separator's shape, (2, 2049, 8193)
     from a 4096/1024 STFT of two channels: both axes bit-identical to the
     plain version, timed beside the bound;
  9. stem separation at full width on the 181 s stereo WAV: the band-split
     mask net (models.separation.separate, the bundled v5 checkpoint), the
     DSP separator (analysis.stems.separate_stems_arrays) and
     separate_stems(path, dir), each called directly. Every stem finite and
     of the input's shape, the DSP stems sum to the mixture within 1e-4,
     the medians launch once per axis per DSP call and never in the net,
     two runs are bit-identical, the written PCM_16 WAVs decode to the
     blend within 1.5 steps of 1/32768 (rounding plus the 32767/32768
     scale), and the card agrees with device="cpu" on the 30 s excerpt
     within 1e-4. Timed: both separators on the card (CUDA events, and one
     run each under torch.profiler), the net's parts, istft at both
     framings, the WAV writes, peak device memory, and a warm
     analyse_track(path, use_stems=True) beside the plain call;
 10. rendering: render_all without plots on phase 4's result (the files,
     report.json's key set), the tempogram graph on the card against the
     CPU within 1e-4, and the one call
     analyse_track(path, output_dir=dir, use_stems=True): with matplotlib
     installed every artefact, the five plots and the four stems; without
     it the stems, report.json and the CSVs, then ImportError from the
     plots (never a silent skip).
 11. the per-module path at full width: analyse_track(path, fused=False) on
     the 181 s WAV, cold and warm, with each stage's ms (progress
     callbacks), one warm call under torch.profiler and peak device memory;
     the medians launch once per axis per call and the fused STFT never
     (also with TA_PALLAS_STFT=1); BPM 118 +- 0.1, every field finite; it
     agrees with the fused float32 path on the card (every field but the
     downbeats, which the two paths decode from different flux curves) and,
     on phase 5's excerpt, with the fused path and with device="cpu" in
     every field (compare_results, rounding_differs=True);
 12. the ms6 / ms5 transports: analyse_track on the 181 s WAV, uploaded
     bytes against 6 / 5 bits a stereo sample pair plus a scale and a base
     per block, BPM 118 +- 0.1 and test_agreement.py's margins against
     float32 (the section count held on the library's sectioned 181 s
     track, where it is decisive), warm wall time beside "ms" and
     "float32"; one ms5 sweep at device_batch 4 over phase 7's library;
 13. the CLI by subprocess: analyze --plots skip (exit 0, report.json's
     BPM), analyze with plots (exit 1 with the ImportError where
     matplotlib is absent), a file that does not decode (exit 1),
     analyze-batch --transport ms5 --device-batch 4 --manifest twice (the
     second run reports the tracks as already done);
 14. the decode tiers and the native host library at full width: each
     tier's presence (absent is no failure; a present tier that fails is);
     the 181 s fixture as PCM_16 WAV and as FLAC (io/flac.encode_flac,
     timed), analyse_track on the FLAC equal to it on the WAV in every
     field through the native FLAC decoder (medians +1 per axis); native
     against numpy FLAC decode on a 30 s excerpt and WAV decode on the
     181 s file (bit-identical, timed); every ta_quantise_* on the 181 s
     track against its numpy plain version (bit-identical, timed); the
     golden Ogg and MP3 vectors through their tiers and the ffmpeg tier,
     and, where libmp3lame and libvorbisenc are, a 181 s MP3 and Ogg
     (BPM 118 +- 0.1, the WAV's key); an ms5 sweep at device_batch 4 over
     the mixed-format files, each lane against its batch-1 analyse_track;
     a StageTimer report of a warm per-module call and a device_trace of
     a warm fused call that names the median kernel;
 15. sequence sharding: analyse_track_sharded on the 181 s WAV at world 1
     (nccl: the halo code with no neighbours) and world 2 (gloo, both
     ranks on the one card), ranks spawned by parallel/mesh.spawn, cold
     and warm: each rank's median launches +1 per axis per call (counted
     in the rank) and the fused STFT never, each result against the fused
     float32 path (compare_results, rounding_differs=True) and every
     rank's result against rank 0's (compare_results), wall times and
     each rank's peak memory; the medians at each world's per-rank HPSS
     shape (1025, frames per shard + 2 halos + 1) bit-identical to the
     plain version, timed beside the bound. A failing rank fails the run;
 16. training: one downbeat train_step (GRU, hidden 256, batch 8, 256
     frames) and one separation_train_step (the v5 widths, batch 4, 1 s)
     on the card against the same step on the host (loss and parameters /
     first moments within 1e-5 of their scale), ms per step and peak
     memory; then python -m track_analyser_tpu_torch.dryrun --world 2
     --backend gloo (dp analysis against one batched graph, the dp x tp
     step against one single-process step, the seq-sharded analysis) on
     the one card;
 17. out-of-family accuracy: the 13 songs of tests/test_independent_eval.py
     (scripts/independent_engine.py, loaded by path and rendered in a pool
     of spawned processes: the fixed song and seeds 1000-1011, every fourth
     at 3/4; mono, 22.05 kHz, 22-47 s) each once through both STFT routes
     (the first calls at each bucket, printed as such), then through
     evaluation.evaluate_song on the card, one line a song (meter, BPM,
     tracked and downbeat F1, the four ΔSI-SDR, the warm analysis and
     separation walls); the fixed song held
     to SINGLE_SONG_GATES and the twelve to DISTRIBUTION_GATES, any failed
     gate failing the run; the medians +1 per axis per analysis and per
     separation; the analyses again with TA_PALLAS_STFT=1 (the STFT kernel
     once a song, the F1 gates again, each song against its cuFFT run by
     compare_results, a flipped decision reported by field); both kernels
     at every launch shape of the phase (the medians bit-identical, the
     STFT within 2e-6 of the frame norm of its plain version and of
     cuFFT), timed at the longest song's shapes beside their bounds (the
     STFT beside cuFFT); seed 1003 on the
     host against the card (compare_results, ΔSI-SDR within 0.01 dB);
 18. the API surface on the card against the same calls on the host:
     stft with a Hamming window, uncentred and centred, at (2, 1 048 576)
     (within 1e-5 of each frame's largest magnitude) and its istft (1e-5
     absolute, also against the signal), downbeat_net.forward on the three
     bundled checkpoints at T = 4 096 (1e-4 absolute), autocorrelate at
     n = 16 385, one lane and two (1e-5 of ac[..., 0]); the native
     binding's available() and has_transport() and native.build.build()
     True; its wall beside the card's name and power limit;
 19. the library sweep over a mesh: analyse_library(mesh=["cuda:0",
     "cuda:0"]), two dispatch workers on the one card, over phase 7's
     library with cuFFT and with TA_PALLAS_STFT=1, at device_batch 1 and
     4: outcomes in source order, the launches equal to the chunks, both
     workers used, every lane against its batch-1 analyse_track (bit for
     bit at batch 1, compare_results at 4), the manifest's resume; a
     kernel launch failure injected into worker 1's second chunk must
     raise out of the sweep and leave no thread running; the 40-source
     library timed with one worker and with two at device_batch 1 and 4
     (wall, ms per track, tracks per card-hour, stage times, peak
     memory). With more than one visible card the default mesh
     (device="cuda", every card) runs too, with each card's share of the
     chunks and its peak memory; the card count is printed either way.
The last two lines before the result are the kernels' JSON record and the
card's name and power limit; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

Imports nothing of JAX: it drives the port only.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import types
import zlib
from pathlib import Path

import numpy as np

# bench.py's first, asserted fixture. (Its default 126-BPM recipe reads
# 126.13 with the reference tempo estimator, on the card and on the CPU
# alike: a bias of the estimator on that fixture, not of the device.)
BPM = 118.0
SEED = 0
SECONDS = 181.0
SR = 44_100
BUCKET = 8_388_608  # a 181 s track's bucket: a (1025, 16 385) spectrogram
MAIN_SHAPE = (1025, 16_385)
STEMS_SHAPE = (2, 2049, 8193)  # the DSP separator's 4096/1024 STFT of two channels
STEMS_TOL = 1e-4  # absolute, on stems of a mixture of peak <= 1
PCM16_STEP = 1.0 / 32768.0
REPORT_KEYS = {
    "audio": {"path", "sample_rate", "duration"},
    "beat": {"bpm", "confidence", "count", "tracked"},
    "downbeat": {"source", "count"},
    "structure": {"label", "category", "start", "end", "confidence"},
    "loudness": {"integrated_lufs", "loudness_range", "true_peak_dbfs", "rms_dbfs"},
    "harmonic": {"key", "key_confidence", "secondary_key", "chord_change_points"},
    "features": {"ltas", "spectral_centroid", "spectral_rolloff"},
    "stereo": {"mid_rms", "side_rms", "correlation", "width"},
}
TABLE_FILES = ("report.json", "beats.csv", "sections.csv", "report.html", "hook.mid", "bass.mid")
PLOT_FILES = ("waveform_beats.png", "tempogram.png", "novelty_boundaries.png", "ltas.png", "stereo_width.png")
SWEEP_BATCH = 4
THROUGHPUT_COPIES = 8  # the sweep's five decodable WAVs, 40 sources
THROUGHPUT_RUNS = 3
MEDIAN_SOURCE = "track_analyser_tpu_torch/csrc/median31.cu"
STFT_SOURCE = "track_analyser_tpu_torch/csrc/stft_mag.cu"
REPLACES = {
    -1: ("median31_time", "track_analyser_tpu/ops/pallas_median.py:82"),
    -2: ("median31_freq", "track_analyser_tpu/ops/pallas_median.py:115"),
}
STFT_REPLACES = "track_analyser_tpu/ops/pallas_stft.py:55"
STFT_TOL = 2e-6  # of each frame's spectral norm, as the reference holds its kernel

# Published H100 SXM figures at its 700 W limit (NVIDIA's data sheet):
# memory rate, and the float32 rate outside the tensor cores (an FMA
# counts two operations).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
# What one 2048-sample frame's |STFT| needs by an FFT, whichever kernel
# computes it: a 1024-point complex FFT (5 N log2 N), the window (2048),
# the untangle of the real spectrum (~14 per bin) and the magnitude (4 per
# bin).
STFT_FLOP_PER_FRAME = 5 * 1024 * 10 + 2048 + 14 * 1024 + 4 * 1025
# The medians' operations are float min/max, as many per output as the
# kernel's generated network runs (median_network), issued at 64 per SM per
# clock on compute capability 9.0 (the CUDA C++ programming guide's
# throughput table, "compare, minimum, maximum"); 132 SMs at the card's
# maximum SM clock.
MINMAX_PER_SM_CLOCK = 64
SMS = 132
# The median kernel takes 0.02-0.25 ms, as little as its wrapper's host
# work (allocation, stream, ctypes): it is timed over this many launches
# back to back (time_cuda_ms).
MEDIAN_TIMED_LAUNCHES = 20


class SmokeFailure(AssertionError):
    """A phase's check failed."""


def check(condition: bool, message: str) -> None:
    if not condition:
        raise SmokeFailure(message)


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


def make_arranged_track(seconds: float, sr: int = SR, bpm: float = 124.0, seed: int = 1) -> np.ndarray:
    """A stereo track in 8-bar sections over a steady kick, each section
    with its own chord and its own parts (hats, bass); returns float32
    (2, n).

    The library's tracks use it rather than ``make_track``, whose bass
    switches every 4 s all track long: its novelty curve is a row of
    near-equal peaks, so which of them pass the section picker's
    threshold is decided by rounding (a 3e-7 difference of the [mid,
    side] STFT moved one section on a 150 s track)."""

    n = int(seconds * sr)
    t = np.arange(n, dtype=np.float64) / sr
    rng = np.random.default_rng(seed)
    beat = 60.0 / bpm
    section = 32 * beat
    roots = (220.0, 174.61, 261.63, 196.0)  # A, F, C, G
    parts = ((0, 0), (1, 1), (1, 0), (0, 1))  # (hats, bass) per section; the kick never stops
    left, right = np.zeros(n), np.zeros(n)
    for k, start in enumerate(np.arange(0.0, seconds, section)):
        s, e = int(start * sr), min(n, int((start + section) * sr))
        root = roots[(k + seed) % 4]
        hats_on, bass_on = parts[k % 4]
        ts = t[s:e]
        chord = 0.12 * np.sin(2 * np.pi * root * ts) + 0.08 * np.sin(2 * np.pi * root * 1.26 * ts)
        chord += 0.06 * np.sin(2 * np.pi * root * 1.5 * ts)
        bass = 0.25 * bass_on * np.sin(2 * np.pi * root / 4 * ts)
        left[s:e] += chord + bass
        right[s:e] += 0.85 * chord + bass
        for b in np.arange(start, min(start + section, seconds), beat):
            ks, ke = int(b * sr), min(e, int(b * sr) + int(0.08 * sr))
            seg = np.arange(ke - ks) / sr
            kick = np.sin(2 * np.pi * (60 + 40 * np.exp(-seg * 60)) * seg) * np.exp(-seg * 30)
            left[ks:ke] += 0.8 * kick
            right[ks:ke] += 0.8 * kick
            hs, he = int((b + beat / 2) * sr), min(e, int((b + beat / 2) * sr) + int(0.02 * sr))
            if hats_on and he > hs:
                hat = rng.normal(0, 0.15, he - hs) * np.exp(-np.arange(he - hs) / (0.004 * sr))
                left[hs:he] += 0.6 * hat
                right[hs:he] += 0.5 * hat
    peak = max(np.abs(left).max(), np.abs(right).max())
    return (np.stack([left, right]) / peak * 0.9).astype(np.float32)


def with_noise_floor(x: np.ndarray, seed: int) -> np.ndarray:
    """``x`` plus -50 dBFS white noise. On noise-free synthetic tones the
    onset envelope between hits is float rounding noise, and onset
    backtracking would pick its minima from two runs' different rounding;
    with a floor the finishers decide on the signal."""

    return x + np.random.default_rng(seed).normal(0.0, 0.003, x.shape).astype(np.float32)


def time_cuda_ms(fn, reps: int = 15, warmup: int = 3, launches: int = 1) -> float:
    """Median milliseconds of ``fn`` on the card, CUDA events around each
    run of ``launches`` calls back to back, divided by ``launches``: with
    more than one, the host's work for the next call overlaps the card's
    for this one, so a short kernel is timed without its launch gap."""

    import torch

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


def bound(nbytes: float, seconds_of_work: float) -> tuple[float, str]:
    """(least milliseconds, what bounds it): the larger of the bytes over
    the memory rate and the operations' time at their peak rate."""

    t_bytes = nbytes / HBM_BYTES_PER_S
    return (max(t_bytes, seconds_of_work) * 1e3, "bytes" if t_bytes >= seconds_of_work else "operations")


def median_network(axis: int) -> tuple[int, float]:
    """(outputs a thread, min/max per output) of the median kernel along
    ``axis`` (-1 time, -2 frequency): the network it runs, as the port's
    generator (ops/median.tile_network) reports it."""

    from track_analyser_tpu_torch.ops import median

    r = median.RUN_TIME if axis == -1 else median.RUN_FREQ
    return r, median.tile_network(r).per_output


def median_bound(numel: int, axis: int, minmax_per_s: float) -> dict:
    """The median kernel's bound on ``numel`` float32 outputs along
    ``axis``: the bytes of one read and one write over the memory rate, the
    network's min/max over their peak rate; the larger binds."""

    r, per_output = median_network(axis)
    nbytes = 2 * numel * 4
    seconds_of_work = per_output * numel / minmax_per_s
    bound_ms, bound_by = bound(nbytes, seconds_of_work)
    return {
        "bound_ms": bound_ms, "bound_by": bound_by, "bytes_bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
        "operations_bound_ms": seconds_of_work * 1e3, "r": r, "minmax_per_output": per_output,
    }


def bound_shares(b: dict, kernel_ms: float) -> str:
    """Both bounds of ``median_bound`` with their shares of ``kernel_ms``."""

    return (
        f"bytes bound {b['bytes_bound_ms']:.4f} ms ({100 * b['bytes_bound_ms'] / kernel_ms:.1f}%), operations bound "
        f"{b['operations_bound_ms']:.4f} ms at {b['minmax_per_output']:g} min/max per output, runs of {b['r']} "
        f"({100 * b['operations_bound_ms'] / kernel_ms:.1f}%); {b['bound_by']} bind"
    )


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


def differing_fields(a, b) -> "list[str]":
    """Names of the numeric fields of two results that are not
    bit-identical (list items collapse to their list, as ``x[]``)."""

    la, lb = dict(numeric_leaves(a)), dict(numeric_leaves(b))
    names = set()
    for key in la.keys() | lb.keys():
        if key not in la or key not in lb or not np.array_equal(la[key], lb[key]):
            names.add(re.sub(r"\[\d+\]", "[]", key))
    return sorted(names)


def equal_score_key(positions: "list[int]") -> tuple:
    """(meter, downbeat indices, slip count) of a 1-based bar-position
    path, the meter read as its largest position.

    The downbeat decoder's bar-position Viterbi scores a path by exactly
    these: every non-downbeat position has the same emission, and a stay
    costs what a skip costs. Paths with one key therefore score the same
    for any accents (e.g. 1,2,1 and 1,3,1 across a shortened 3/4 bar), so
    each is optimal wherever the other is, and float rounding picks
    between them; without a slip the key fixes the path."""

    p = np.asarray(positions, dtype=int)
    meter = int(p.max()) if p.size else 0
    slips = int(np.count_nonzero(p[1:] != p[:-1] % max(meter, 1) + 1))
    return meter, tuple(np.flatnonzero(p == 1).tolist()), slips


def compare_results(
    got, ref, label: str = "gpu vs cpu", *, rounding_differs: bool = False, downbeats: bool = True
) -> None:
    """Every TrackAnalysisResult field within the CPU parity tests'
    tolerances (tests/test_torch_pipeline.py).

    Downbeat bar positions must be equal. With ``rounding_differs`` (the
    two results come from differently rounded graphs: another device,
    another batch width, another STFT) a path that differs must score
    exactly what the other does (``equal_score_key``, with a slip), so both
    are optimal for either result's accents; such a tie is printed.
    ``downbeats=False`` leaves the downbeat times and bar positions out
    (the source is still compared): the per-module and the fused path feed
    the decoder different flux curves, in the JAX package as in the port
    (ROADMAP.md Queue 3), so their bar paths may differ off a tie."""

    def close(a, b, atol, what, rtol=0.0):
        a, b = np.asarray(a, dtype=float), np.asarray(b, dtype=float)
        check(a.shape == b.shape, f"{label}: {what}: shape {a.shape} vs {b.shape}")
        err = float(np.max(np.abs(a - b))) if a.size else 0.0
        ok = np.allclose(a, b, rtol=rtol, atol=atol)
        check(ok, f"{label}: {what}: max |diff| {err} beyond atol {atol} rtol {rtol}")
        return err

    worst = {}
    worst["bpm"] = close(got.beat.bpm, ref.beat.bpm, 1e-3, "bpm")
    close(got.beat.confidence, ref.beat.confidence, 1e-3, "beat confidence")
    worst["beat_times"] = close(got.beat.beat_times, ref.beat.beat_times, 1e-4, "beat times")
    worst["tracked_times"] = close(got.beat.tracked_times, ref.beat.tracked_times, 0.012, "tracked beats")
    check(got.downbeat.source == ref.downbeat.source, f"{label}: downbeat source")
    gp, rp = got.downbeat.beat_positions, ref.downbeat.beat_positions
    if not downbeats:
        print(
            f"{label}: downbeats not compared: {len(got.downbeat.downbeat_times)} against "
            f"{len(ref.downbeat.downbeat_times)}, bar positions {'equal' if gp == rp else 'differ'}",
            flush=True,
        )
    else:
        worst["downbeat_times"] = close(
            got.downbeat.downbeat_times, ref.downbeat.downbeat_times, 1e-4, "downbeat times"
        )
    if downbeats and gp != rp:
        gk, rk = equal_score_key(gp), equal_score_key(rp)
        check(rounding_differs, f"{label}: beat positions differ")
        check(gk == rk and rk[2] > 0, f"{label}: beat positions differ off a tie: {gk} vs {rk}")
        at = [j for j, (g, r) in enumerate(zip(gp, rp)) if g != r]
        print(
            f"{label}: bar positions differ at beats {at} on an exact tie of the bar-position "
            f"Viterbi (meter {rk[0]}, {rk[2]} slips, the same downbeats)",
            flush=True,
        )
    gs, rs = got.structure.segments, ref.structure.segments
    check(len(gs) == len(rs), f"{label}: section count {len(gs)} vs {len(rs)}")
    check([s.label for s in gs] == [s.label for s in rs], f"{label}: section labels")
    check([s.category for s in gs] == [s.category for s in rs], f"{label}: section categories")
    close([s.start for s in gs], [s.start for s in rs], 1e-3, "section starts")
    close([s.end for s in gs], [s.end for s in rs], 1e-3, "section ends")
    for attr in ("integrated_lufs", "loudness_range", "true_peak_dbfs", "rms_dbfs"):
        worst[attr] = close(getattr(got.loudness, attr), getattr(ref.loudness, attr), 5e-3, attr)
    worst["momentary"] = close(got.loudness.momentary_lufs, ref.loudness.momentary_lufs, 2e-2, "momentary")
    worst["short_term"] = close(got.loudness.short_term_lufs, ref.loudness.short_term_lufs, 2e-2, "short-term")
    gh, rh = got.harmonic, ref.harmonic
    check(gh.primary_key.key == rh.primary_key.key, f"{label}: primary key")
    check(gh.secondary_key.key == rh.secondary_key.key, f"{label}: secondary key")
    close(gh.primary_key.confidence, rh.primary_key.confidence, 1e-3, "key confidence")
    check([h.chord for h in gh.chord_hints] == [h.chord for h in rh.chord_hints], f"{label}: chord hints")
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
                f"{label}: {attr} {column}",
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
    print(f"{label} worst |diff|:", json.dumps({k: float(v) for k, v in worst.items()}), flush=True)


def frame_norm_err(got, ref) -> float:
    """max |got - ref| relative to each (channel, frame)'s spectral norm."""

    import torch

    norm = torch.linalg.vector_norm(ref, dim=-2, keepdim=True)
    return float(((got - ref).abs() / (norm + 1e-9)).max())


def host_cpu() -> str:
    """The host CPU as /proc/cpuinfo names it (a host may report its
    model name as "unknown": the vendor, family, model and stepping still
    tell the part) and the logical core count."""

    try:
        lines = Path("/proc/cpuinfo").read_text().splitlines()
    except OSError:
        return f"CPU not named (no /proc/cpuinfo), {os.cpu_count()} logical cores"
    info: dict = {}
    for line in lines:
        key, _, value = line.partition(":")
        info.setdefault(key.strip(), value.strip())
    part = ", ".join(f"{k} {info[k]}" for k in ("vendor_id", "cpu family", "model", "stepping", "cpu MHz") if k in info)
    return f"{info.get('model name', 'no model name')} ({part}), {os.cpu_count()} logical cores"


@contextlib.contextmanager
def counting(module, names: "tuple[str, ...]"):
    """Count the calls of ``module.<name>`` for each name inside the block
    (the callers look the function up on the module at each call)."""

    calls = dict.fromkeys(names, 0)
    real = {name: getattr(module, name) for name in names}

    def counted(name):
        def call(*args, **kwargs):
            calls[name] += 1
            return real[name](*args, **kwargs)

        return call

    for name in names:
        setattr(module, name, counted(name))
    try:
        yield calls
    finally:
        for name, fn in real.items():
            setattr(module, name, fn)


# Copies of the tests' ctypes encoders (tests/test_mp3.py, tests/test_vorbis.py)
# over the system libmp3lame and libvorbisenc: phase 14 writes its MP3 and
# Ogg with them. The Ogg one also marks the end of the stream, so that the
# last partial block is encoded too.
def encode_mp3(path: Path, pcm: np.ndarray, sr: int, kbps: int = 128) -> None:
    """Mono float PCM to a constant-rate MP3 through libmp3lame."""

    import ctypes
    import ctypes.util

    lame = ctypes.CDLL(ctypes.util.find_library("mp3lame"))
    lame.lame_init.restype = ctypes.c_void_p
    gfp = ctypes.c_void_p(lame.lame_init())
    for setter, value in (("in_samplerate", sr), ("num_channels", 1), ("mode", 3), ("brate", kbps)):
        getattr(lame, f"lame_set_{setter}")(gfp, value)
    check(lame.lame_init_params(gfp) >= 0, "lame_init_params failed")
    ints = np.clip(pcm * 32767.0, -32768, 32767).astype(np.int16)
    out = ctypes.create_string_buffer(int(1.25 * ints.size + 7200))
    n = lame.lame_encode_buffer(gfp, ints.ctypes.data_as(ctypes.POINTER(ctypes.c_short)), None, ints.size, out, len(out))
    check(n >= 0, f"lame_encode_buffer returned {n}")
    data = out.raw[:n]
    n = lame.lame_encode_flush(gfp, out, len(out))
    data += out.raw[: max(n, 0)]
    lame.lame_close(gfp)
    path.write_bytes(data)


def encode_ogg(path: Path, pcm: np.ndarray, sr: int) -> None:
    """Mono float PCM to Ogg Vorbis (VBR quality 0.4) through libvorbisenc."""

    import ctypes
    import ctypes.util

    class Packet(ctypes.Structure):
        _fields_ = [("packet", ctypes.POINTER(ctypes.c_ubyte)), ("bytes", ctypes.c_long), ("b_o_s", ctypes.c_long),
                    ("e_o_s", ctypes.c_long), ("granulepos", ctypes.c_int64), ("packetno", ctypes.c_int64)]

    class Page(ctypes.Structure):
        _fields_ = [("header", ctypes.POINTER(ctypes.c_ubyte)), ("header_len", ctypes.c_long),
                    ("body", ctypes.POINTER(ctypes.c_ubyte)), ("body_len", ctypes.c_long)]

    def opaque():
        # c_double units: the real structs hold pointers and doubles and
        # need 8-byte alignment, which a byte blob would not give
        return (ctypes.c_double * 2048)()

    ogg, vb, enc = (ctypes.CDLL(ctypes.util.find_library(name)) for name in ("ogg", "vorbis", "vorbisenc"))
    vi, vc, vd, vblk, stream = (opaque() for _ in range(5))
    vb.vorbis_info_init(vi)
    check(enc.vorbis_encode_init_vbr(vi, ctypes.c_long(1), ctypes.c_long(sr), ctypes.c_float(0.4)) == 0, "vorbis_encode_init_vbr failed")
    vb.vorbis_comment_init(vc)
    vb.vorbis_analysis_init(vd, vi)
    vb.vorbis_block_init(vd, vblk)
    ogg.ogg_stream_init(stream, 1)
    headers = [Packet(), Packet(), Packet()]
    vb.vorbis_analysis_headerout(vd, vc, *(ctypes.byref(h) for h in headers))
    for packet in headers:
        ogg.ogg_stream_packetin(stream, ctypes.byref(packet))
    out = bytearray()
    page = Page()

    def flush_pages(force: bool) -> None:
        fn = ogg.ogg_stream_flush if force else ogg.ogg_stream_pageout
        while fn(stream, ctypes.byref(page)) != 0:
            out.extend(ctypes.string_at(page.header, page.header_len))
            out.extend(ctypes.string_at(page.body, page.body_len))

    flush_pages(True)
    vb.vorbis_analysis_buffer.restype = ctypes.POINTER(ctypes.POINTER(ctypes.c_float))
    def drain() -> None:
        while vb.vorbis_analysis_blockout(vd, vblk) == 1:
            vb.vorbis_analysis(vblk, None)
            vb.vorbis_bitrate_addblock(vblk)
            packet = Packet()
            while vb.vorbis_bitrate_flushpacket(vd, ctypes.byref(packet)) == 1:
                ogg.ogg_stream_packetin(stream, ctypes.byref(packet))
                flush_pages(False)

    pcm = np.ascontiguousarray(pcm, dtype=np.float32)
    for pos in range(0, pcm.size, 1024):
        n = min(1024, pcm.size - pos)
        ctypes.memmove(vb.vorbis_analysis_buffer(vd, n)[0], pcm[pos : pos + n].ctypes.data, n * 4)
        vb.vorbis_analysis_wrote(vd, n)
        drain()
    vb.vorbis_analysis_wrote(vd, 0)  # the end of the stream
    drain()
    flush_pages(True)
    ogg.ogg_stream_clear(stream)
    vb.vorbis_block_clear(vblk)
    vb.vorbis_dsp_clear(vd)
    vb.vorbis_comment_clear(vc)
    vb.vorbis_info_clear(vi)
    path.write_bytes(bytes(out))


def wall_ms(fn):
    """(result, host milliseconds) of ``fn``, the card drained on both sides."""

    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def profiled(label: str, fn, card: str) -> None:
    """One run of ``fn`` under torch.profiler: launches, device-busy time, top kernels."""

    import torch

    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=activities) as prof:
        _out, ms = wall_ms(fn)
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA and e.device_time_total > 0]
    if not events:
        print(f"{label} under the profiler: no device events recorded (launches and busy time not measured)")
        return
    busy_ms = sum(e.device_time_total for e in events) / 1e3
    by_name: dict = {}
    for e in events:
        us, count = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (us + e.device_time_total, count + 1)
    print(
        f"{label} under the profiler: wall {ms:.2f} ms, {len(events)} device kernels/copies, device busy "
        f"{busy_ms:.2f} ms ({100 * busy_ms / ms:.1f}% of wall) -- {card}"
    )
    for name, (us, count) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]:
        print(f"  {us / 1e3:9.3f} ms  x{count:<4d} {name[:100]}")


# The sweep's library (phases 7, 12 and 13): (file, recipe, seconds, bpm,
# seed, stereo); None marks the file that does not decode.
LIBRARY = [
    ("a_118bpm.wav", make_track, SECONDS, BPM, SEED, True),
    ("b.wav", make_arranged_track, SECONDS, 124.0, 1, True),
    ("c_mono.wav", make_arranged_track, 150.0, 128.0, 2, False),
    ("bad.wav", None, None, None, None, None),
    ("d.wav", make_arranged_track, 120.0, 122.0, 3, True),
    ("e_30s.wav", make_arranged_track, 30.0, 126.0, 11, True),
]


def write_library(folder: Path) -> "tuple[list[str], list[int], list[int]]":
    """Write LIBRARY into ``folder``: (sources, decodable sample counts,
    indices of the decodable sources)."""

    from track_analyser_tpu_torch.io import write_wav

    sources, lengths = [], []
    for name, recipe, seconds, bpm, seed, stereo in LIBRARY:
        path = folder / name
        if recipe is None:
            path.write_bytes(b"RIFF this file is not audio " * 64)
        else:
            x = with_noise_floor(recipe(seconds, bpm=bpm, seed=seed), 100 + seed)
            write_wav(path, x if stereo else x.mean(axis=0), SR)
            lengths.append(int(seconds * SR))
        sources.append(str(path))
    return sources, lengths, [i for i, item in enumerate(LIBRARY) if item[1] is not None]


def sweep_chunks(lengths: "list[int]", lanes: int) -> int:
    """Chunks of a sweep at ``lanes`` per dispatch: one bucket's tracks share them."""

    from track_analyser_tpu_torch.parallel import batch

    per_bucket: dict = {}
    for n in lengths:
        per_bucket[batch.ms_bucket_length(n)] = per_bucket.get(batch.ms_bucket_length(n), 0) + 1
    return sum(math.ceil(c / lanes) for c in per_bucket.values())


class Launches:
    """Reads and zeroes every kernel wrapper's launch count."""

    def __init__(self) -> None:
        from track_analyser_tpu_torch.ops import fused_stft, median

        self.median = median.median31
        self.stft = fused_stft.stft_magnitude

    def reset(self) -> None:
        self.median.launches = self.median.launches_time = self.median.launches_freq = 0
        self.stft.launches = 0

    def read(self) -> dict:
        return {
            "median31_time": self.median.launches_time,
            "median31_freq": self.median.launches_freq,
            "stft_magnitude": self.stft.launches,
        }


ONCE_PER_AXIS = {"median31_time": 1, "median31_freq": 1, "stft_magnitude": 0}
# test_agreement.py's decision margins for ms6 and ms5 against float32:
# integrated LUFS and true peak (dB); BPM within 0.1, sections within one.
SUBBYTE_MARGIN_DB = (0.15, 0.1)
SUBBYTE_BITS = {"ms6": 6, "ms5": 5}


def per_module_phase(card: str, launches: "Launches", path_launches: dict, main_track: np.ndarray, excerpt: np.ndarray) -> dict:
    """Phase 11: ``analyse_track(path, fused=False)`` at full width on the
    181 s WAV, its launches, stage times, profile and peak memory, against
    the fused path on the card and against the host on the excerpt."""

    import torch

    from track_analyser_tpu_torch import analyse_track
    from track_analyser_tpu_torch.io import write_wav
    from track_analyser_tpu_torch.utils import AudioInput

    phase("11 per-module path: analyse_track(path, fused=False) on the 181 s WAV")
    out: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "track_181s.wav")
        write_wav(path, main_track, SR)
        torch.cuda.reset_peak_memory_stats()
        launches.reset()
        walls = []
        for label in ("cold", "warm"):
            before = launches.read()
            stamps: list = []
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            result = analyse_track(
                path, fused=False, device="cuda", progress_callback=lambda s: stamps.append((s, time.perf_counter()))
            )
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
            after = launches.read()
            check(
                all(after[k] - before[k] == v for k, v in ONCE_PER_AXIS.items()),
                f"per-module {label} run: launches went {before} -> {after}, expected +{ONCE_PER_AXIS}",
            )
            marks = [t0] + [t for _stage, t in stamps]
            stages = {stage: round((t - marks[i]) * 1e3, 1) for i, (stage, t) in enumerate(stamps)}
            check(list(stages) == ["audio", "beats", "structure", "loudness", "harmonic", "features", "stereo"], f"stages {list(stages)}")
            print(f"{label} analyse_track(path, fused=False): {walls[-1]:.1f} ms wall; ms per stage {json.dumps(stages)} -- {card}")
        out["stages_ms"] = stages
        path_launches["analyse_track(fused=False) (2 calls)"] = launches.read()
        out["peak_mib"] = torch.cuda.max_memory_allocated() / 2**20
        os.environ["TA_PALLAS_STFT"] = "1"  # acts on the fused graph only
        try:
            launches.reset()
            analyse_track(path, fused=False, device="cuda")
            path_launches["analyse_track(fused=False), TA_PALLAS_STFT=1"] = counts = launches.read()
        finally:
            os.environ.pop("TA_PALLAS_STFT", None)
        check(counts == ONCE_PER_AXIS, f"per-module with TA_PALLAS_STFT=1: launches {counts}, expected {ONCE_PER_AXIS}")
        profiled("warm analyse_track(path, fused=False)", lambda: analyse_track(path, fused=False, device="cuda"), card)
        analyse_track(path, transport="float32", device="cuda")  # warms the fused float32 path
        fused, fused_ms = wall_ms(lambda: analyse_track(path, transport="float32", device="cuda"))
    out["walls_ms"], out["fused_ms"] = walls, fused_ms
    print(
        f"warm analyse_track(path): per-module {walls[-1]:.1f} ms, fused float32 {fused_ms:.1f} ms; peak device memory "
        f"of the per-module calls {out['peak_mib']:.0f} MiB; launches with TA_PALLAS_STFT=1 {json.dumps(counts)} -- {card}"
    )
    check(abs(result.beat.bpm - BPM) <= 0.1, f"per-module bpm {result.beat.bpm} not within 0.1 of {BPM}")
    leaves = list(numeric_leaves(result))
    for name, value in leaves:
        check(bool(np.all(np.isfinite(value))), f"per-module {name} is not finite")
    print(f"per-module: bpm {result.beat.bpm:.4f}, {len(leaves)} numeric fields, all finite")
    # On this track the two paths' downbeat decoders read different flux
    # curves and part (ROADMAP.md Queue 3); every other field is held.
    compare_results(result, fused, "per-module vs fused (float32) on the card", rounding_differs=True, downbeats=False)
    print(f"fields not bit-identical to the fused path: {differing_fields(result, fused) or 'none'}")
    audio = AudioInput(samples=excerpt.mean(axis=0), sample_rate=SR, stereo_samples=excerpt)
    on_card = analyse_track(audio, fused=False, device="cuda")
    on_host = analyse_track(audio, fused=False, device="cpu")
    compare_results(on_card, on_host, "per-module gpu vs cpu (30 s excerpt)", rounding_differs=True)
    fused_card = analyse_track(audio, transport="float32", device="cuda")
    compare_results(on_card, fused_card, "per-module vs fused (float32) on the card (30 s excerpt)", rounding_differs=True)
    return out


def hold_margins(label: str, result, exact, *, sections: bool) -> None:
    """``result`` inside test_agreement.py's decision margins around the
    float32 ``exact``: integrated LUFS, true peak, key, downbeat source
    and, with ``sections``, the section count within one; finite fields."""

    loud_tol, peak_tol = SUBBYTE_MARGIN_DB
    off_lufs = abs(result.loudness.integrated_lufs - exact.loudness.integrated_lufs)
    off_peak = abs(result.loudness.true_peak_dbfs - exact.loudness.true_peak_dbfs)
    check(off_lufs <= loud_tol and off_peak <= peak_tol, f"{label}: LUFS off {off_lufs}, true peak off {off_peak}")
    check(result.harmonic.primary_key.key == exact.harmonic.primary_key.key, f"{label}: key")
    check(result.downbeat.source == exact.downbeat.source, f"{label}: downbeat source")
    n_sec, n_exact = len(result.structure.segments), len(exact.structure.segments)
    check(not sections or abs(n_sec - n_exact) <= 1, f"{label}: {n_sec} sections against {n_exact}")
    for name, value in numeric_leaves(result):
        check(bool(np.all(np.isfinite(value))), f"{label}: {name} is not finite")
    print(
        f"{label}: bpm {result.beat.bpm:.4f} ({exact.beat.bpm:.4f} with float32), LUFS off by {off_lufs:.4f}, true peak "
        f"by {off_peak:.4f}, {n_sec} sections ({n_exact} with float32{'' if sections else ', not held'}), key "
        f"{result.harmonic.primary_key.key}"
    )


def subbyte_phase(card: str, launches: "Launches", path_launches: dict, main_track: np.ndarray,
                  sources: "list[str]", lengths: "list[int]", good: "list[int]") -> dict:
    """Phase 12: the ms6 / ms5 transports on the 181 s WAV (bytes, BPM,
    agreement with float32, warm wall time, beside ms and float32), the
    same margins on the library's sectioned 181 s track, and an ms5 sweep."""

    import torch

    from track_analyser_tpu_torch import analyse_track
    from track_analyser_tpu_torch.io import write_wav
    from track_analyser_tpu_torch.parallel import batch
    from track_analyser_tpu_torch.pipeline import TrackAnalysisResult

    phase(f"12 ms6 / ms5 transports: analyse_track on the 181 s WAV, an ms5 sweep at device_batch {SWEEP_BATCH}")
    n = main_track.shape[-1]
    bucket = batch.ms_bucket_length(n)
    runs: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "track_181s.wav")
        write_wav(path, main_track, SR)
        for transport in ("float32", "ms", "ms6", "ms5"):
            batch.reset_upload_bytes()
            analyse_track(path, transport=transport, device="cuda")  # warms this transport's plans
            nbytes = batch.upload_bytes()
            result, ms = wall_ms(lambda: analyse_track(path, transport=transport, device="cuda"))
            runs[transport] = (result, nbytes, ms)
    sectioned = sources[1]  # make_arranged_track, 181 s: its sections are decisive
    exact_sectioned = analyse_track(sectioned, transport="float32", device="cuda")
    for transport, bits in SUBBYTE_BITS.items():
        result, nbytes, ms = runs[transport]
        block = batch._ms_block(bits)
        want = bucket * bits // 8 + 8 * (bucket // block) + 8  # codes, a float32 scale and base per block, n_valid
        check(nbytes == want, f"{transport}: uploaded {nbytes} bytes, expected {want}")
        check(abs(result.beat.bpm - BPM) <= 0.1, f"{transport}: bpm {result.beat.bpm} not within 0.1 of {BPM}")
        # bench.py's recipe sits on the section picker's threshold (ROADMAP.md
        # Queue 3): its section count is held on the sectioned track instead.
        hold_margins(f"{transport}, 118-BPM track", result, runs["float32"][0], sections=False)
        other = analyse_track(sectioned, transport=transport, device="cuda")
        check(abs(other.beat.bpm - exact_sectioned.beat.bpm) <= 0.1, f"{transport}, sectioned track: bpm {other.beat.bpm}")
        hold_margins(f"{transport}, sectioned track", other, exact_sectioned, sections=True)
    for transport, (_result, nbytes, ms) in runs.items():
        print(
            f"{transport}: uploads {nbytes} bytes ({nbytes / n:.4f} B per stereo sample pair), warm analyse_track(path) "
            f"{ms:.1f} ms -- {card}"
        )

    chunks = sweep_chunks(lengths, SWEEP_BATCH)
    launches.reset()
    outcome, sweep_ms = wall_ms(
        lambda: batch.analyse_library(sources, device="cuda", transport="ms5", device_batch=SWEEP_BATCH)
    )
    path_launches["sweep (ms5)"] = counts = launches.read()
    expected = {"median31_time": chunks, "median31_freq": chunks, "stft_magnitude": 0}
    check(counts == expected, f"ms5 sweep: launches {counts}, expected {expected}")
    for i, item in enumerate(outcome):
        want = TrackAnalysisResult if i in good else batch.TrackFailure
        check(isinstance(item, want), f"ms5 sweep: source {i} gave {type(item).__name__}")
    check(abs(outcome[0].beat.bpm - BPM) <= 0.1, f"ms5 sweep: bpm {outcome[0].beat.bpm}")
    print(f"ms5 sweep of {len(sources)} sources: {sweep_ms:.1f} ms wall (cold for this setting), launches {json.dumps(counts)} -- {card}")
    torch.cuda.synchronize()
    return {k: (v[1], v[2]) for k, v in runs.items()}


def cli_phase(card: str, main_track: np.ndarray, main_bpm: float, sources: "list[str]", good: "list[int]") -> None:
    """Phase 13: the port's CLI in subprocesses on the card: analyze with
    and without plots, a file that does not decode, analyze-batch with a
    manifest run twice."""

    import importlib.util

    from track_analyser_tpu_torch.io import write_wav

    phase("13 CLI by subprocess: analyze, its error probes, analyze-batch with resume")
    have_plots = importlib.util.find_spec("matplotlib") is not None
    repo = Path(__file__).resolve().parent

    def cli(*args: object) -> "subprocess.CompletedProcess":
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "track_analyser_tpu_torch.cli", *map(str, args)],
            cwd=repo, capture_output=True, text=True, timeout=600,
        )
        shown = " ".join(Path(str(a)).name if isinstance(a, Path) or "/" in str(a) else str(a) for a in args)
        print(f"cli {shown}: exit {proc.returncode} in {(time.perf_counter() - t0) * 1e3:.0f} ms -- {card}")
        return proc

    with tempfile.TemporaryDirectory() as tmp:
        wav = Path(tmp) / "track_181s.wav"
        write_wav(wav, main_track, SR)
        proc = cli("analyze", wav, "--out", Path(tmp) / "skip", "--plots", "skip")
        check(proc.returncode == 0, f"analyze --plots skip: exit {proc.returncode}: {proc.stdout} {proc.stderr[-2000:]}")
        bpm = json.loads((Path(tmp) / "skip" / "report.json").read_text())["beat"]["bpm"]
        check(abs(bpm - main_bpm) <= 1e-9 and f"BPM: {bpm:.2f}" in proc.stdout, f"analyze: report.json bpm {bpm}, phase 4 {main_bpm}")
        print(f"analyze --plots skip: exit 0, report.json bpm {bpm:.4f} (phase 4's analyse_track: {main_bpm:.4f})")

        proc = cli("analyze", wav, "--out", Path(tmp) / "plots")
        if have_plots:
            check(proc.returncode == 0, f"analyze with plots: exit {proc.returncode}: {proc.stdout}")
            check(all((Path(tmp) / "plots" / name).is_file() for name in PLOT_FILES), "analyze: plots missing")
        else:
            check(proc.returncode == 1 and proc.stdout.startswith("Error: ") and "matplotlib" in proc.stdout,
                  f"analyze without matplotlib: exit {proc.returncode}: {proc.stdout}")
        print(f"analyze with plots (matplotlib {'present' if have_plots else 'absent'}): exit {proc.returncode}: {proc.stdout.strip()[:200]}")

        bad = Path(tmp) / "bad.wav"
        bad.write_bytes(b"this file is not audio\n" * 32)
        proc = cli("analyze", bad, "--out", Path(tmp) / "bad")
        check(proc.returncode == 1 and proc.stdout.startswith("Error: Could not decode audio file"), f"decode probe: {proc.returncode} {proc.stdout}")
        print(f"a file that does not decode: exit 1, {proc.stdout.strip()}")

        argv = ["analyze-batch", *sources, "--out", Path(tmp) / "library", "--manifest", Path(tmp) / "m.jsonl",
                "--transport", "ms5", "--device-batch", SWEEP_BATCH] + ([] if have_plots else ["--plots", "skip"])
        n_good, n_bad = len(good), len(sources) - len(good)
        for run, want in (("first", f"({n_good} track(s), {n_bad} failed)"), ("second", f"(0 track(s), {n_good} already done, {n_bad} failed)")):
            proc = cli(*argv)
            head = proc.stdout.splitlines()[0] if proc.stdout else ""
            check(proc.returncode == 0 and head.endswith(want), f"analyze-batch, {run} run: exit {proc.returncode}: {proc.stdout} {proc.stderr[-2000:]}")
            print(f"analyze-batch ({run} run): {head}")
        for i in good:
            folder = Path(tmp) / "library" / Path(sources[i]).stem
            check((folder / "report.json").is_file() and (folder / "hook.mid").is_file(), f"{folder.name}: artefacts missing")


QUANTISERS = ("quantise_i8", "quantise_i16", "quantise_i16_stereo", "quantise_ms", "quantise_mid", "quantise_mid6", "quantise_mid5")


def hold_quantisers(card: str, cpu: str, stereo: np.ndarray) -> dict:
    """Every ``ta_quantise_*`` of the native library on a full track, held
    bit for bit against its numpy plain version on the same input (the
    float64 stereo sums to 1e-12: the C++ adds in another order); both
    timed on the host. Returns {symbol: {"native_ms", "plain_ms"}}."""

    from track_analyser_tpu_torch.native import binding
    from track_analyser_tpu_torch.parallel import batch
    from track_analyser_tpu_torch.utils import AudioInput

    n = stereo.shape[-1]
    audio = AudioInput(samples=stereo.mean(axis=0), sample_rate=SR, stereo_samples=stereo)
    source = batch._source_channels(audio)
    bucket, ms_bucket = batch.bucket_length(n), batch.ms_bucket_length(n)
    qlen = batch._ms_quantise_len(n, ms_bucket)
    mono = np.ascontiguousarray(stereo[0])

    def plain_i16_mono():
        padded = np.zeros(bucket, dtype=np.float32)
        padded[:n] = mono
        return batch._quantise_i16(padded)

    # symbol -> (native call, plain call)
    cases = {
        "quantise_i8": (lambda: binding.quantise_i8(source, bucket, batch._I8_BLOCK), lambda: batch._quantise_i8(batch._pad_track(audio, bucket)[0])),
        "quantise_i16": (lambda: (binding.quantise_i16(mono, bucket),), lambda: (plain_i16_mono(),)),
        "quantise_i16_stereo": (lambda: (binding.quantise_i16_stereo(source, bucket),), lambda: (batch._quantise_i16(batch._pad_track(audio, bucket)[0]),)),
        # the port ships the mid only: ta_quantise_ms's mid, scales and sums are held against the mid's plain version
        "quantise_ms": (lambda: (lambda o: (o[0], o[1], o[5]))(binding.quantise_ms(source, qlen, batch._I8_BLOCK)),
                        lambda: batch._quantise_mid_range(source, n, 0, qlen)),
        "quantise_mid": (lambda: binding.quantise_mid(source, qlen, batch._I8_BLOCK), lambda: batch._quantise_mid_range(source, n, 0, qlen)),
        "quantise_mid6": (lambda: binding.quantise_mid6(source, qlen, batch._I8_BLOCK), lambda: batch._quantise_mid6_range(source, n, 0, qlen)),
        "quantise_mid5": (lambda: binding.quantise_mid5(source, qlen, batch._MS5_BLOCK), lambda: batch._quantise_mid5_range(source, n, 0, qlen)),
    }
    out = {}
    for symbol, (native, plain) in cases.items():
        got = native()
        native_ms = statistics.median(wall_ms(native)[1] for _ in range(3))
        ref, plain_ms = wall_ms(plain)
        for k, (g, r) in enumerate(zip(got, ref)):
            g, r = np.asarray(g), np.asarray(r)
            check(g.shape == r.shape and g.dtype == r.dtype, f"ta_{symbol} output {k}: {g.shape} {g.dtype} vs {r.shape} {r.dtype}")
            if g.dtype == np.float64 and g.shape == (8,):  # the stereo sums
                check(bool(np.allclose(g, r, rtol=1e-12, atol=0.0)), f"ta_{symbol} stereo sums beyond 1e-12")
            else:
                check(np.array_equal(g, r), f"ta_{symbol} output {k} is not bit-identical to the plain version")
        out[f"ta_{symbol}"] = {"native_ms": native_ms, "plain_ms": plain_ms}
        what = "its mid, scales and sums against the mid's plain version" if symbol == "quantise_ms" else "against its plain version"
        print(f"ta_{symbol} on the {n / SR:.0f} s track, {what}: bit-identical; native {native_ms:.2f} ms, numpy {plain_ms:.2f} ms -- {card}; host {cpu}")
    return out


def decode_phase(card: str, cpu: str, launches: "Launches", path_launches: dict, main_track: np.ndarray) -> dict:
    """Phase 14: the decode tiers and the native host library at full
    width: FLAC against the PCM_16 WAV of the same samples through
    analyse_track, native against numpy decode and quantisers, the Ogg,
    MP3 and ffmpeg tiers, a mixed-format sweep, StageTimer and
    device_trace."""

    import ctypes.util

    from track_analyser_tpu_torch import analyse_track
    from track_analyser_tpu_torch.io import decode_file, decode_wav, encode_flac, ffmpeg, mpg123, vorbis, write_wav
    from track_analyser_tpu_torch.io.flac import decode_flac
    from track_analyser_tpu_torch.native import binding
    from track_analyser_tpu_torch.parallel import batch
    from track_analyser_tpu_torch.profiling import StageTimer, device_trace

    phase("14 decode tiers and the native host library: FLAC, Ogg, MP3, ffmpeg, the quantisers, a mixed sweep")
    phase_start = time.perf_counter()
    out: dict = {}
    tiers = {"Ogg (libvorbisfile)": vorbis.unavailable_reason(), "MP3 (libmpg123)": mpg123.unavailable_reason(),
             "ffmpeg (libta_ffmpeg)": ffmpeg.unavailable_reason()}
    encoders = {"mp3": ctypes.util.find_library("mp3lame"), "ogg": all(ctypes.util.find_library(n) for n in ("ogg", "vorbis", "vorbisenc"))}
    print("tier native WAV/FLAC (libta_native): present")
    for name, reason in tiers.items():
        print(f"tier {name}: {'present' if reason is None else f'absent ({reason})'}")
    print(f"encoders for the 181 s MP3 / Ogg: libmp3lame {'present' if encoders['mp3'] else 'absent'}, libvorbisenc {'present' if encoders['ogg'] else 'absent'}")

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        # 1. the 181 s fixture as PCM_16 WAV, and as FLAC of the WAV's integers
        wav = tmp / "track_181s.wav"
        write_wav(wav, main_track, SR, subtype="PCM_16")
        ints = np.round(decode_wav(wav)[0] * 32768.0).astype(np.int64)
        flac, encode_ms = wall_ms(lambda: encode_flac(tmp / "track_181s.flac", ints, SR))
        print(f"181 s fixture: PCM_16 WAV {wav.stat().st_size} bytes; FLAC {flac.stat().st_size} bytes, encoded by io/flac.encode_flac in {encode_ms / 1e3:.2f} s; host {cpu}")

        # 2. analyse_track on the FLAC equals it on the WAV, through the native FLAC decoder
        analyse_track(str(wav), device="cuda")  # the PCM_16 file's first call
        launches.reset()
        with counting(binding, ("decode", "decode_flac")) as decodes, counting(batch.native_binding, QUANTISERS) as quantised:
            from_flac, flac_ms = wall_ms(lambda: analyse_track(str(flac), device="cuda"))
        path_launches["analyse_track(FLAC)"] = counts = launches.read()
        check(counts == ONCE_PER_AXIS, f"analyse_track(FLAC): launches {counts}, expected {ONCE_PER_AXIS}")
        check(decodes == {"decode": 1, "decode_flac": 1}, f"analyse_track(FLAC): native decoder calls {decodes}")
        from_wav, wav_ms = wall_ms(lambda: analyse_track(str(wav), device="cuda"))
        fields = differing_fields(from_flac, from_wav)
        check(not fields, f"analyse_track(FLAC) differs from analyse_track(WAV) in {fields}")
        print(
            f"analyse_track(FLAC) equals analyse_track(PCM_16 WAV) in every field; native decoder calls {json.dumps(decodes)}, "
            f"quantiser calls {json.dumps({k: v for k, v in quantised.items() if v})}, launches {json.dumps(counts)}; warm wall "
            f"{flac_ms:.1f} ms FLAC, {wav_ms:.1f} ms WAV -- {card}"
        )

        # 3. native against numpy FLAC decode on the 30 s excerpt, and the full track's native decode
        excerpt = encode_flac(tmp / "excerpt_30s.flac", ints[:, : 30 * SR], SR)
        native, native_ms = wall_ms(lambda: binding.decode_flac(str(excerpt)))
        plain, plain_ms = wall_ms(lambda: decode_flac(excerpt))
        check(native is not None and np.array_equal(native[0], plain[0]) and native[1:] == plain[1:], "native and numpy FLAC decode differ on the 30 s excerpt")
        check(np.array_equal(native[0], (ints[:, : 30 * SR] / 32768.0).astype(np.float32)), "the 30 s FLAC does not decode to its samples")
        full_ms = statistics.median(wall_ms(lambda: binding.decode_flac(str(flac)))[1] for _ in range(3))
        out["flac_decode_ms"] = {"native_30s": native_ms, "numpy_30s": plain_ms, "native_181s": full_ms}
        print(f"FLAC decode, 30 s excerpt: native {native_ms:.2f} ms, numpy {plain_ms:.1f} ms, bit-identical; native on the 181 s FLAC {full_ms:.2f} ms -- host {cpu}")

        # 4. native against numpy WAV decode on the 181 s PCM_16 WAV
        native, native_ms = wall_ms(lambda: binding.decode(str(wav)))
        native_ms = min(native_ms, wall_ms(lambda: binding.decode(str(wav)))[1])
        plain, plain_ms = wall_ms(lambda: decode_wav(wav))
        check(native is not None and np.array_equal(native[0], plain[0]) and native[1:] == plain[1:], "native and numpy WAV decode differ")
        out["wav_decode_ms"] = {"native": native_ms, "numpy": plain_ms}
        print(f"WAV decode, 181 s PCM_16: native {native_ms:.2f} ms, numpy {plain_ms:.2f} ms, bit-identical -- host {cpu}")

        # 5. every quantiser on the 181 s track against its plain version
        out["quantisers"] = hold_quantisers(card, cpu, plain[0])

        # 6. the Ogg, MP3 and ffmpeg tiers on the golden vectors, and on a 181 s track where the encoders are here
        golden = Path(__file__).resolve().parent / "tests" / "golden"
        extra = []
        if tiers["Ogg (libvorbisfile)"] is None:
            blob = json.loads((golden / "ogg_tiny.json").read_text())
            (tmp / "golden.ogg").write_bytes(zlib.decompress(bytes.fromhex(blob["ogg_hex_zlib"])))
            data, rate, meta = decode_file(tmp / "golden.ogg")
            spec = np.abs(np.fft.rfft(data[0, : rate // 2]))
            peak_hz = float(np.fft.rfftfreq(rate // 2, 1 / rate)[np.argmax(spec)])
            check(meta["file_type"] == "OGG" and rate == blob["sample_rate"] and data.shape[1] > blob["n_samples_min"], f"golden Ogg: {meta}")
            check(abs(peak_hz - blob["tone_hz"]) < 5.0, f"golden Ogg: peak at {peak_hz} Hz")
            print(f"golden Ogg through the libvorbisfile tier: {data.shape} at {rate} Hz, peak {peak_hz:.1f} Hz")
        mp3_golden = None
        if tiers["MP3 (libmpg123)"] is None or tiers["ffmpeg (libta_ffmpeg)"] is None:
            blob = json.loads((golden / "mp3_tiny.json").read_text())
            mp3_golden = tmp / "golden.mp3"
            mp3_golden.write_bytes(zlib.decompress(bytes.fromhex(blob["mp3_hex_zlib"])))
        if tiers["MP3 (libmpg123)"] is None:
            data, rate, meta = decode_file(mp3_golden)
            want = np.frombuffer(bytes.fromhex(blob["decoded_ch0_f32_hex"]), dtype=np.float32)
            off = float(np.abs(data[0][:: blob["decoded_stride"]][: want.size] - want).max())
            check(meta["file_type"] == "MP3" and rate == blob["sample_rate"] and off <= 1e-4, f"golden MP3: {meta}, off by {off}")
            print(f"golden MP3 through the libmpg123 tier: {data.shape} at {rate} Hz, within {off:.1e} of the committed samples")
        if tiers["ffmpeg (libta_ffmpeg)"] is None:
            got = ffmpeg.decode(str(mp3_golden))
            check(got is not None and got[1] == blob["sample_rate"] and bool(np.isfinite(got[0]).all()), "the ffmpeg tier declined the golden MP3")
            print(f"golden MP3 through the ffmpeg tier: {got[0].shape} at {got[1]} Hz, codec {got[2]['subtype']}")
        for kind, tier, encode in (("mp3", "MP3 (libmpg123)", encode_mp3), ("ogg", "Ogg (libvorbisfile)", encode_ogg)):
            if not encoders[kind] or tiers[tier] is not None:
                print(f"181 s {kind}: not run ({'no encoder' if not encoders[kind] else 'no decoder'})")
                continue
            path = tmp / f"track_181s.{kind}"
            mono = main_track.mean(axis=0)
            _none, enc_ms = wall_ms(lambda: encode(path, mono, SR))
            # The codec's delay (an MP3 encoder's priming and first frame)
            # shifts the beat grid against the frames, which moves this
            # fixture's tempo reading as the same shift of the WAV does; the
            # held file is encoded from the track advanced by that delay.
            decoded = decode_file(path)[0][0]
            lag = int(np.argmax(np.correlate(decoded[: 4 * SR // 10], mono[: SR // 10], "valid")))
            as_encoded = analyse_track(str(path), device="cuda")
            if lag:
                encode(path, mono[lag:], SR)
                analyse_track(str(path), device="cuda")  # this length's first call
            result, ms = wall_ms(lambda: analyse_track(str(path), device="cuda"))
            check(abs(result.beat.bpm - BPM) <= 0.1, f"181 s {kind}: bpm {result.beat.bpm}")
            check(result.harmonic.primary_key.key == from_wav.harmonic.primary_key.key, f"181 s {kind}: key {result.harmonic.primary_key.key}")
            extra.append(path)
            print(
                f"181 s {kind} (encoded in {enc_ms:.0f} ms): the decoded stream lags the input by {lag} samples, bpm {as_encoded.beat.bpm:.4f} "
                f"as encoded; encoded from the track advanced by the lag: bpm {result.beat.bpm:.4f}, key {result.harmonic.primary_key.key} "
                f"as the WAV's; warm analyse_track {ms:.1f} ms -- {card}"
            )

        # 7. a mixed-format sweep, ms5 at device_batch 4, against batch-1 analyse_track
        sources = [str(wav), str(flac), str(excerpt)] + [str(p) for p in extra]
        chunks = sweep_chunks([decode_file(s)[0].shape[-1] for s in sources], SWEEP_BATCH)
        launches.reset()
        with counting(batch.native_binding, QUANTISERS) as quantised:
            outcome, sweep_ms = wall_ms(lambda: batch.analyse_library(sources, device="cuda", transport="ms5", device_batch=SWEEP_BATCH))
        path_launches["sweep (mixed formats, ms5)"] = counts = launches.read()
        expected = {"median31_time": chunks, "median31_freq": chunks, "stft_magnitude": 0}
        check(counts == expected, f"mixed sweep: launches {counts}, expected {expected}")
        check(quantised["quantise_mid5"] == len(sources) and sum(quantised.values()) == len(sources), f"mixed sweep: quantiser calls {quantised}")
        for source, lane in zip(sources, outcome):
            single = analyse_track(source, transport="ms5", device="cuda")
            compare_results(lane, single, f"mixed sweep lane {Path(source).name} vs analyse_track", rounding_differs=True)
        print(
            f"mixed sweep of {len(sources)} sources ({', '.join(Path(s).suffix for s in sources)}): {sweep_ms:.1f} ms wall, every lane "
            f"agrees with its batch-1 analyse_track; launches {json.dumps(counts)}; quantiser calls {json.dumps({k: v for k, v in quantised.items() if v})} -- {card}"
        )

        # 8. StageTimer on a warm per-module call, device_trace of a warm fused call
        timer = StageTimer()
        analyse_track(str(wav), fused=False, device="cuda")
        analyse_track(str(wav), fused=False, device="cuda", progress_callback=timer.callback())
        print(f"StageTimer, warm analyse_track(path, fused=False) -- {card}:\n{timer.report()}")
        with device_trace(tmp / "trace") as trace_path:
            analyse_track(str(wav), device="cuda")
        events = json.loads(trace_path.read_text())["traceEvents"]
        median_events = [e for e in events if "median31_kernel" in e.get("name", "") and e.get("dur")]
        check(len(median_events) == 2, f"device_trace: {len(median_events)} median kernel events, expected 2")
        print(
            f"device_trace of a warm analyse_track(path): {trace_path.stat().st_size} bytes, {len(events)} events; median kernels "
            f"{[(e['name'][:40], round(e['dur'] / 1e3, 3)) for e in median_events]} (name, device ms) -- {card}"
        )
    print(f"phase 14: {time.perf_counter() - phase_start:.1f} s")
    return out


def sharded_rank(group, audio, runs: int, card: str) -> dict:
    """One rank of phase 15: ``analyse_track_sharded`` ``runs`` times (the
    first cold), each call's kernel launches in this rank (the counts set
    to 0 first), its wall time and the rank's peak device memory; then,
    uncounted, the device part alone (``sharded_track_outputs``) and one
    call under torch.profiler."""

    import torch

    from track_analyser_tpu_torch.parallel import sharded

    launches = Launches()
    launches.reset()
    torch.cuda.reset_peak_memory_stats()
    walls, counts = [], []
    for _ in range(runs):
        before = launches.read()
        result, ms = wall_ms(lambda: sharded.analyse_track_sharded(audio, group))
        after = launches.read()
        walls.append(ms)
        counts.append({k: after[k] - before[k] for k in after})
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    n = len(audio.samples)
    stereo = audio.stereo_samples if audio.stereo_samples is not None else np.stack([audio.samples, audio.samples])
    _, outputs_ms = wall_ms(lambda: sharded.sharded_track_outputs(stereo, n, audio.sample_rate, group))
    profiled(f"world {group.size} rank {group.rank}: analyse_track_sharded", lambda: sharded.analyse_track_sharded(audio, group), card)
    return {
        "rank": group.rank, "device": str(group.device), "backend": group.backend, "walls_ms": walls,
        "launches": counts, "peak_mib": peak_mib, "outputs_ms": outputs_ms,
        "hpss_shape": sharded.hpss_shape(n, audio.sample_rate, group.size), "result": result,
    }


def sharded_phase(card: str, path_launches: dict, main_track: np.ndarray, minmax_per_s: float) -> dict:
    """Phase 15: ``analyse_track_sharded`` on the 181 s WAV at world 1
    (nccl) and world 2 (gloo, both ranks on the one card), each rank's
    median launches, each result against the fused float32 path and every
    rank's against rank 0's, and the
    medians at each rank's HPSS shape against their plain version."""

    import torch

    from track_analyser_tpu_torch.io import write_wav
    from track_analyser_tpu_torch.ops import median
    from track_analyser_tpu_torch.parallel import batch, mesh
    from track_analyser_tpu_torch.utils import coerce_audio

    phase("15 sequence sharding: analyse_track_sharded on the 181 s WAV at world 1 (nccl) and world 2 (gloo, one card)")
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "track_181s.wav"
        write_wav(path, main_track, SR)
        audio = coerce_audio(str(path))
    fused_ms = []
    for _ in range(2):  # the second call warm
        fused, ms = wall_ms(lambda: batch.analyse_track_fused(audio, transport="float32", device="cuda"))
        fused_ms.append(ms)
    print(f"fused float32 analyse_track_fused on the decoded WAV: {fused_ms[0]:.1f} ms, warm {fused_ms[1]:.1f} ms -- {card}")
    total = dict.fromkeys(ONCE_PER_AXIS, 0)
    shapes, walls = {}, {}
    for world, backend in ((1, "nccl"), (2, "gloo")):
        t0 = time.perf_counter()
        ranks = mesh.spawn(sharded_rank, world, (audio, 2, card), backend=backend, device="cuda", timeout_s=600.0)
        spawn_s = time.perf_counter() - t0
        for r in ranks:
            for call, counts in enumerate(r["launches"]):
                check(counts == ONCE_PER_AXIS, f"world {world} rank {r['rank']} call {call}: launches {counts}, expected {ONCE_PER_AXIS}")
                for k, v in counts.items():
                    total[k] += v
            print(
                f"world {world} ({r['backend']}) rank {r['rank']} on {r['device']}: cold {r['walls_ms'][0]:.1f} ms, "
                f"warm {r['walls_ms'][1]:.1f} ms (sharded_track_outputs alone {r['outputs_ms']:.1f} ms), "
                f"launches per call {json.dumps(r['launches'][-1])}, "
                f"peak {r['peak_mib']:.0f} MiB, HPSS input {r['hpss_shape']} -- {card}"
            )
        walls[world] = max(r["walls_ms"][1] for r in ranks)
        print(f"world {world}: {spawn_s:.1f} s for the spawn and both calls; warm wall (slowest rank) {walls[world]:.1f} ms "
              f"against the fused float32 path's {fused_ms[1]:.1f} ms -- {card}")
        compare_results(ranks[0]["result"], fused, f"sharded world {world} ({backend}) vs fused float32", rounding_differs=True)
        for r in ranks[1:]:
            compare_results(r["result"], ranks[0]["result"], f"sharded world {world} ({backend}) rank {r['rank']} vs rank 0")
        shapes[world] = ranks[0]["hpss_shape"]
    path_launches["sharded"] = total
    print(f"sharded launches over both worlds (2 calls each): {json.dumps(total)}")

    gen = torch.Generator(device="cuda").manual_seed(15)
    timings = {}
    for world, shape in shapes.items():
        x = torch.rand(shape, device="cuda", generator=gen)
        for axis in (-1, -2):
            got = median.median31(x, axis)
            ref = median.median31_reference(x, axis)
            torch.cuda.synchronize()
            err = float((got - ref).abs().max())
            check(torch.equal(got, ref), f"median31 axis {axis} shape {shape}: max |diff| {err}")
            kernel_ms = time_cuda_ms(lambda: median.median31(x, axis), launches=MEDIAN_TIMED_LAUNCHES)
            plain_ms = time_cuda_ms(lambda: median.median31_reference(x, axis), reps=5, warmup=1)
            b = median_bound(x.numel(), axis, minmax_per_s)
            timings[(world, axis)] = {"shape": list(shape), "ms": kernel_ms, "plain_ms": plain_ms, **b, "max_abs_err": err}
            print(
                f"{REPLACES[axis][0]} at world {world}'s per-rank shape {shape}: bit-identical; kernel {kernel_ms:.4f} ms, "
                f"plain {plain_ms:.4f} ms, {bound_shares(b, kernel_ms)} -- {card}"
            )
        del x, got, ref
    return timings


def training_phase(card: str) -> None:
    """Phase 16: one downbeat ``train_step`` (GRU, hidden 256, batch 8,
    256 frames) and one ``separation_train_step`` (v5 widths, batch 4,
    1 s) on the card against the same step on the host, ms per step and
    peak memory; then ``dryrun --world 2`` under gloo on the one card."""

    import torch

    from track_analyser_tpu_torch.models import downbeat_net, separation_net, training

    phase("16 training: train_step and separation_train_step on the card vs the host; dryrun --world 2 (gloo, one card)")

    def rel(a, b) -> float:
        return float(np.max(np.abs(a - b)) / max(float(np.max(np.abs(b))), 1e-30))

    # ---- downbeat GRU: SGD with momentum --------------------------------------
    feats, labels = downbeat_net.synthetic_batch(np.random.default_rng(16), batch=8, frames=256, n_mels=128)
    steps = {}
    for dev in ("cuda", "cpu"):
        model = downbeat_net.init_params(hidden=256, generator=torch.Generator().manual_seed(16)).to(dev)
        model, momentum, loss = downbeat_net.train_step(model, downbeat_net.init_momentum(model), feats, labels)
        steps[dev] = (float(loss), downbeat_net.params_to_jax(model))
    worst = max(rel(steps["cuda"][1][k], v) for k, v in steps["cpu"][1].items())
    check(abs(steps["cuda"][0] - steps["cpu"][0]) <= 1e-5 * abs(steps["cpu"][0]) and worst <= 1e-5,
          f"downbeat train_step card vs host: loss {steps['cuda'][0]} vs {steps['cpu'][0]}, parameters {worst}")
    model = downbeat_net.init_params(hidden=256).to("cuda")
    momentum = downbeat_net.init_momentum(model)
    f_dev = torch.from_numpy(feats).cuda()
    l_dev = torch.from_numpy(labels).cuda()
    downbeat_net.train_step(model, momentum, f_dev, l_dev)  # warm
    torch.cuda.reset_peak_memory_stats()
    ms = statistics.median(wall_ms(lambda: downbeat_net.train_step(model, momentum, f_dev, l_dev))[1] for _ in range(5))
    print(
        f"downbeat train_step (GRU hidden 256, batch 8, 256 frames): card vs host loss {steps['cuda'][0]:.6f} / "
        f"{steps['cpu'][0]:.6f}, parameters within {worst:.2e} of their scale; {ms:.2f} ms a step (median of 5), "
        f"peak {torch.cuda.max_memory_allocated() / 2**20:.0f} MiB -- {card}"
    )

    # ---- separation net at the v5 widths: Adam ----------------------------------
    rng = np.random.default_rng(16)
    stems = np.stack([training.synth_stems(rng, 1.0) for _ in range(4)])
    mix = stems.sum(axis=1)
    sep = {}
    for dev in ("cuda", "cpu"):
        model = separation_net.init_params(
            d_model=144, n_blocks=4, dilations=(1, 3, 9, 27), generator=torch.Generator().manual_seed(16)
        ).to(dev)
        model, (m, v, _), loss = training.separation_train_step(model, training.init_opt_state(model), mix, stems)
        sep[dev] = (float(loss), {k: t.cpu().numpy() for k, t in m.items()}, separation_net.params_to_jax(model))
    m_scale = max(float(np.abs(x).max()) for x in sep["cpu"][1].values())
    m_err = max(float(np.abs(sep["cuda"][1][k] - x).max()) for k, x in sep["cpu"][1].items()) / m_scale
    check(abs(sep["cuda"][0] - sep["cpu"][0]) <= 1e-5 * abs(sep["cpu"][0]) and m_err <= 1e-5,
          f"separation_train_step card vs host: loss {sep['cuda'][0]} vs {sep['cpu'][0]}, first moments {m_err}")
    model = separation_net.init_params(d_model=144, n_blocks=4, dilations=(1, 3, 9, 27)).to("cuda")
    opt = training.init_opt_state(model)
    mix_dev, stems_dev = torch.from_numpy(mix).cuda(), torch.from_numpy(stems).cuda()
    model, opt, _ = training.separation_train_step(model, opt, mix_dev, stems_dev)  # warm
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(5):
        (model, opt, _), t = wall_ms(lambda: training.separation_train_step(model, opt, mix_dev, stems_dev))
        times.append(t)
    print(
        f"separation_train_step (v5 widths: 144 wide, 4 blocks, dilations 1/3/9/27; batch 4, 1 s): card vs host "
        f"loss {sep['cuda'][0]:.6f} / {sep['cpu'][0]:.6f}, first moments within {m_err:.2e} of their scale; "
        f"{statistics.median(times):.2f} ms a step (median of 5), peak {torch.cuda.max_memory_allocated() / 2**20:.0f} MiB -- {card}"
    )

    # ---- the dry run: dp analysis, dp x tp step, seq sharding ---------------------
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "track_analyser_tpu_torch.dryrun", "--world", "2", "--backend", "gloo"],
        cwd=Path(__file__).resolve().parent, capture_output=True, text=True, timeout=900,
    )
    print(proc.stdout.strip())
    check(proc.returncode == 0, f"dryrun --world 2: exit {proc.returncode}\n{proc.stderr[-4000:]}")
    print(f"dryrun --world 2 --backend gloo: exit 0 in {time.perf_counter() - t0:.1f} s -- {card}")

# Phase 17: the repo's out-of-family songs (scripts/independent_engine.py),
# as tests/test_independent_eval.py renders them: the fixed song, and the
# twelve randomised songs of seeds 1000-1011, every fourth forced to 3/4
# (:126-138), mono at 22.05 kHz.
ENGINE = Path(__file__).resolve().parent / "scripts" / "independent_engine.py"
INDEPENDENT_SR = 22_050
INDEPENDENT_SEEDS = tuple(range(1000, 1012))
INDEPENDENT_CPU_SEED = 1003  # meter 3, also run on the host
SI_SDR_HOST_DB = 0.01  # card against host, per stem


def render_independent(seed: "int | None") -> tuple:
    """(label, meter, stems, mix, beat times, bar starts) of one song of
    the independent engine, loaded by path: ``None`` is the fixed song
    (render_song, 4/4), a seed a randomised song. Runs in a worker."""

    spec = importlib.util.spec_from_file_location("independent_engine", ENGINE)
    engine = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(engine)
    if seed is None:
        stems, mix, beats, bars = engine.render_song(sr=INDEPENDENT_SR)
        return "fixed", 4, stems, mix, beats, bars
    meter = 3 if (seed - INDEPENDENT_SEEDS[0]) % 4 == 3 else None
    stems, mix, beats, bars, meta = engine.render_random_song(seed, sr=INDEPENDENT_SR, meter=meter)
    return str(seed), meta["meter"], stems, mix, beats, bars


@contextlib.contextmanager
def launch_shapes(module, symbol: str, shape_args: slice):
    """Record, for every launch of ``module``'s kernel inside the block,
    the arguments ``shape_args`` of its C entry point ``symbol`` (the
    wrapper looks its library up through ``module._library`` at each
    call). The launch counts are untouched. A replayed CUDA graph launches
    its kernels without the wrapper, so the block starts with no captured
    graph: each shape's first call runs the wrapper (eagerly, then in its
    capture)."""

    from track_analyser_tpu_torch.parallel import batch

    batch.clear_graphs()
    real = module._library
    seen = []

    def recording():
        launch = getattr(real(), symbol)

        def record(*args):
            seen.append(tuple(args[shape_args]))
            return launch(*args)

        return types.SimpleNamespace(**{symbol: record})

    module._library = recording
    try:
        yield seen
    finally:
        module._library = real


def independent_phase(card: str, launches: "Launches", path_launches: dict, minmax_per_s: float) -> dict:
    """Phase 17: the accuracy gates of tests/test_independent_eval.py on
    the card, under cuFFT and under TA_PALLAS_STFT=1; the kernels at the
    22.05 kHz shapes; one song on the host against the card. Returns the
    kernels' timings at the new shapes."""

    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    import torch

    from track_analyser_tpu_torch import evaluation
    from track_analyser_tpu_torch.ops import fused_stft, median
    from track_analyser_tpu_torch.ops.stft import magnitude
    from track_analyser_tpu_torch.parallel.batch import ms_bucket_length

    phase("17 out-of-family accuracy: the independent engine's 13 songs at 22.05 kHz, fused analysis + DSP separator")
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    with ProcessPoolExecutor(max_workers=min(8, os.cpu_count() or 1), mp_context=multiprocessing.get_context("spawn")) as pool:
        songs = list(pool.map(render_independent, (None,) + INDEPENDENT_SEEDS))
    print(f"rendered {len(songs)} songs ({sum(len(s[3]) for s in songs) / INDEPENDENT_SR:.1f} s of audio) in {time.perf_counter() - t0:.1f} s on the host")

    def line(label, meter, row, where: str = card) -> str:
        head = (
            f"song {label:>5} meter {meter} (decoded {row.decoded_meter}, {row.downbeat_source}): bpm {row.bpm:.3f} | tracked F1 "
            f"{row.beat_f1:.4f} downbeat F1 {row.downbeat_f1:.4f} | analysis {row.analysis_s * 1e3:.1f} ms"
        )
        if not row.delta_si_sdr:
            return f"{head} -- {where}"
        deltas = " ".join(f"{n} {row.delta_si_sdr[n]:+.2f}" if n in row.delta_si_sdr else f"{n} silent" for n in evaluation.STEMS)
        return f"{head}, separation {row.separation_s * 1e3:.1f} ms | ΔSI-SDR dB {deltas} -- {where}"

    def gates(rows, f1_only: bool = False) -> None:
        fixed, spread = rows[:1], rows[1:]
        single, dist = evaluation.SINGLE_SONG_GATES, evaluation.DISTRIBUTION_GATES
        if f1_only:
            single = [g for g in single if g.metric not in evaluation.STEMS]
            dist = [g for g in dist if g.metric not in evaluation.STEMS]
        failures = [f"fixed song: {f}" for f in evaluation.check_gates(fixed, single)]
        failures += [f"randomised songs: {f}" for f in evaluation.check_gates(spread, dist)]
        for f in failures:
            print(f"GATE FAILED {f}")
        check(not failures, f"{len(failures)} accuracy gate(s) failed: {failures}")
        f1 = np.array([r.beat_f1 for r in spread]), np.array([r.downbeat_f1 for r in spread])
        m3 = np.array([r.downbeat_f1 for r in spread if r.meter == 3])
        print(
            f"gates hold: fixed song tracked {fixed[0].beat_f1:.4f} downbeat {fixed[0].downbeat_f1:.4f}; randomised tracked "
            f"median {np.median(f1[0]):.4f} min {f1[0].min():.4f}, downbeat median {np.median(f1[1]):.4f} min "
            f"{f1[1].min():.4f}, 3/4 median {np.median(m3):.4f} over {m3.size}"
            + ("" if f1_only else "; ΔSI-SDR medians " + ", ".join(
                f"{n} {np.median([r.delta_si_sdr[n] for r in spread if n in r.delta_si_sdr]):+.2f}" for n in evaluation.STEMS
            ))
        )

    # ---- first calls: the 22.05 kHz buckets are new to the card ----------------
    # The first analysis at a bucket, and the first separation at a length,
    # pay that shape's plans and allocations. Each song goes once through
    # both STFT routes here, so that the passes below read warm walls.
    seen = set()
    for label, meter, stems, mix, beats, bars in songs:
        bucket = ms_bucket_length(len(mix))
        cold = evaluation.evaluate_song(stems, mix, beats, bars, sample_rate=INDEPENDENT_SR, meter=meter, device="cuda")
        os.environ["TA_PALLAS_STFT"] = "1"
        try:
            cold_fused = evaluation.evaluate_song(stems, mix, beats, bars, sample_rate=INDEPENDENT_SR, meter=meter, device="cuda", separate=False)
        finally:
            del os.environ["TA_PALLAS_STFT"]
        print(
            f"first call: song {label:>5} bucket {bucket} ({'seen before' if bucket in seen else 'first at its bucket'}): analysis "
            f"{cold.analysis_s * 1e3:.1f} ms, separation {cold.separation_s * 1e3:.1f} ms, TA_PALLAS_STFT=1 analysis "
            f"{cold_fused.analysis_s * 1e3:.1f} ms -- {card}"
        )
        seen.add(bucket)

    # ---- the main path: evaluate_song on the card (cuFFT) ----------------------
    launches.reset()
    with launch_shapes(median, "median31_launch", slice(2, 6)) as median_shapes:
        rows = [
            evaluation.evaluate_song(stems, mix, beats, bars, sample_rate=INDEPENDENT_SR, meter=meter, device="cuda")
            for _label, meter, stems, mix, beats, bars in songs
        ]
    path_launches[f"independent songs ({len(songs)}, cuFFT)"] = counts = launches.read()
    expected = {"median31_time": 2 * len(songs), "median31_freq": 2 * len(songs), "stft_magnitude": 0}
    check(counts == expected, f"independent songs: launches {counts}, expected {expected} (+1 per axis per analysis and per separation)")
    for (label, meter, *_), row in zip(songs, rows):
        print(line(label, meter, row))
    print(f"launches over the {len(songs)} songs: {json.dumps(counts)}")
    gates(rows)

    # ---- the same analyses through the fused STFT kernel ----------------------
    launches.reset()
    os.environ["TA_PALLAS_STFT"] = "1"
    try:
        with launch_shapes(fused_stft, "stft_mag_launch", slice(3, 5)) as stft_shapes:
            fused_rows = [
                evaluation.evaluate_song(stems, mix, beats, bars, sample_rate=INDEPENDENT_SR, meter=meter, device="cuda", separate=False)
                for _label, meter, stems, mix, beats, bars in songs
            ]
    finally:
        del os.environ["TA_PALLAS_STFT"]
    path_launches[f"independent songs ({len(songs)}, TA_PALLAS_STFT=1)"] = counts = launches.read()
    expected = {"median31_time": len(songs), "median31_freq": len(songs), "stft_magnitude": len(songs)}
    check(counts == expected, f"independent songs, TA_PALLAS_STFT=1: launches {counts}, expected {expected}")
    flipped = {}
    for (label, meter, *_), row, ref in zip(songs, fused_rows, rows):
        print(line(label, meter, row, f"TA_PALLAS_STFT=1 -- {card}"))
        try:
            compare_results(row.result, ref.result, f"song {label}: TA_PALLAS_STFT=1 vs cuFFT", rounding_differs=True)
        except SmokeFailure as exc:  # a flipped decision is the finding here, reported by field
            flipped[label] = differing_fields(row.result, ref.result)
            print(f"song {label}: TA_PALLAS_STFT=1 vs cuFFT: a decision flipped: {exc}; fields not bit-identical: {flipped[label]}")
    print(f"TA_PALLAS_STFT=1 against cuFFT: {len(songs) - len(flipped)} of {len(songs)} songs within compare_results; flipped: {json.dumps(flipped)}")
    print(f"launches over the {len(songs)} songs: {json.dumps(counts)}")
    gates(fused_rows, f1_only=True)

    # ---- the kernels at this phase's shapes ------------------------------------
    timings = {}
    gen = torch.Generator(device="cuda").manual_seed(17)
    distinct = sorted(set(median_shapes))
    print(f"median31 launch shapes (batch, rows, cols, axis_time): {distinct}")
    for batch, n_rows, cols, axis_time in distinct:
        x = torch.rand((batch, n_rows, cols), device="cuda", generator=gen)
        axis = -1 if axis_time else -2
        got, ref = median.median31(x, axis), median.median31_reference(x, axis)
        err = float((got - ref).abs().max())
        check(torch.equal(got, ref), f"median31 axis {axis} at {tuple(x.shape)}: max |diff| {err}")
    print(f"median31 bit-identical to median31_reference at all {len(distinct)} launch shapes")
    # Timed at the longest song's shapes: the analysis spectrogram
    # (2048/512) and the separator's (4096/1024).
    for key, n_rows in (("analysis", 1025), ("separator", 2049)):
        shape = max((s[:3] for s in median_shapes if s[1] == n_rows), key=lambda s: s[2])
        x = torch.rand(shape, device="cuda", generator=gen)
        for axis in (-1, -2):
            kernel_ms = time_cuda_ms(lambda: median.median31(x, axis), launches=MEDIAN_TIMED_LAUNCHES)
            plain_ms = time_cuda_ms(lambda: median.median31_reference(x, axis), reps=5, warmup=1)
            b = median_bound(x.numel(), axis, minmax_per_s)
            timings[(key, axis)] = {"shape": list(shape), "ms": kernel_ms, "plain_ms": plain_ms, **b, "max_abs_err": 0.0}
            print(f"{REPLACES[axis][0]} at the {key}'s {shape}: kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, {bound_shares(b, kernel_ms)} -- {card}")
        del x
    distinct = sorted(set(stft_shapes))
    print(f"stft_magnitude launch shapes (channels, samples): {distinct}")
    worst = {"max_abs_err": 0.0, "plain": 0.0, "cufft": 0.0}
    for channels, n in distinct:
        y = torch.randn((channels, n), device="cuda", generator=gen) * 0.3
        got = fused_stft.stft_magnitude(y, 2048, 512)
        plain = fused_stft.stft_magnitude_reference(y, 2048, 512)
        e_plain, e_fft = frame_norm_err(got, plain), frame_norm_err(got, magnitude(y, 2048, 512))
        check(e_plain < STFT_TOL and e_fft < STFT_TOL, f"stft at {(channels, n)}: frame-norm error {e_plain} vs plain, {e_fft} vs cuFFT, beyond {STFT_TOL}")
        worst = {"max_abs_err": max(worst["max_abs_err"], float((got - plain).abs().max())), "plain": max(worst["plain"], e_plain), "cufft": max(worst["cufft"], e_fft)}
    print(
        f"stft_magnitude within {STFT_TOL} of each frame's norm at all {len(distinct)} launch shapes: worst frame-norm "
        f"error vs plain {worst['plain']:.3e}, vs cuFFT {worst['cufft']:.3e}, max |diff| vs plain {worst['max_abs_err']:.3e}"
    )
    # Timed at the longest song's shape.
    channels, n = max(distinct, key=lambda s: s[1])
    y = torch.randn((channels, n), device="cuda", generator=gen) * 0.3
    frames = 1 + n // 512
    kernel_ms = time_cuda_ms(lambda: fused_stft.stft_magnitude(y, 2048, 512), reps=10, warmup=2)
    plain_ms = time_cuda_ms(lambda: fused_stft.stft_magnitude_reference(y, 2048, 512), reps=5, warmup=1)
    library_ms = time_cuda_ms(lambda: magnitude(y, 2048, 512), reps=10, warmup=2)
    bound_ms, bound_by = bound(4 * channels * n + 4 * channels * 1025 * frames, channels * frames * STFT_FLOP_PER_FRAME / FP32_FLOP_PER_S)
    timings["stft"] = {
        "shape": [channels, n], "ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "max_abs_err": worst["max_abs_err"], "max_frame_norm_err": max(worst["plain"], worst["cufft"]),
    }
    print(
        f"stft_magnitude at {(channels, n)}: kernel {kernel_ms:.4f} ms, plain {plain_ms:.3f} ms, cuFFT {library_ms:.4f} ms, "
        f"bound {bound_ms:.4f} ms ({bound_by}) -- {card}"
    )
    del y, got, plain

    # ---- one song on the host against the card ---------------------------------
    k = 1 + INDEPENDENT_SEEDS.index(INDEPENDENT_CPU_SEED)
    label, meter, stems, mix, beats, bars = songs[k]
    host = evaluation.evaluate_song(stems, mix, beats, bars, sample_rate=INDEPENDENT_SR, meter=meter, device="cpu")
    print(line(label, meter, host, "on the host CPU"))
    compare_results(rows[k].result, host.result, f"song {label}: card vs host", rounding_differs=True)
    off = {n: abs(rows[k].delta_si_sdr[n] - host.delta_si_sdr[n]) for n in host.delta_si_sdr}
    check(rows[k].delta_si_sdr.keys() == host.delta_si_sdr.keys(), f"song {label}: stems scored {sorted(rows[k].delta_si_sdr)} vs {sorted(host.delta_si_sdr)}")
    check(max(off.values()) <= SI_SDR_HOST_DB, f"song {label}: ΔSI-SDR card vs host {off}, beyond {SI_SDR_HOST_DB} dB")
    print(
        f"song {label}: card and host agree in every field (compare_results); F1 card {rows[k].beat_f1:.4f} / "
        f"{rows[k].downbeat_f1:.4f}, host {host.beat_f1:.4f} / {host.downbeat_f1:.4f}; ΔSI-SDR within {max(off.values()):.2e} dB"
    )
    print(f"phase 17: {time.perf_counter() - t_phase:.1f} s -- {card}")
    return timings


def api_surface_phase(card: str) -> None:
    """Phase 18: the public functions that close the port's surface
    against the JAX package's, on the card against the same calls on the
    host: ``stft`` with a Hamming window (uncentred and centred) and its
    ``istft`` at (2, 1 048 576), ``downbeat_net.forward`` on the three
    bundled checkpoints at T = 4 096, ``onset.autocorrelate`` at
    n = 16 385; and the native binding's ``available`` /
    ``has_transport`` and ``native.build.build``. The tolerances are the
    CPU parity tests' (tests/test_torch_api_surface.py)."""

    import torch

    from track_analyser_tpu_torch.models import downbeat_net
    from track_analyser_tpu_torch.native import binding
    from track_analyser_tpu_torch.native import build as native_build
    from track_analyser_tpu_torch.ops import onset
    from track_analyser_tpu_torch.ops.stft import istft, stft

    phase("18 the API surface on the card: stft/istft window= and center=, downbeat_net.forward, autocorrelate, native build")
    t_phase = time.perf_counter()
    rng = np.random.default_rng(18)
    n_fft, hop, n = 2048, 512, 1_048_576
    win = np.hamming(n_fft)
    host = torch.from_numpy((0.3 * rng.standard_normal((2, n))).astype(np.float32))
    card_y = host.cuda()
    for center in (False, True):
        want = stft(host, n_fft, hop, window=win, center=center)
        got = stft(card_y, n_fft, hop, window=win, center=center).cpu()
        scale = want.abs().amax(dim=-2)  # each frame's largest magnitude
        err = max(float(((got.real - want.real).abs().amax(dim=-2) / scale).max()),
                  float(((got.imag - want.imag).abs().amax(dim=-2) / scale).max()))
        check(got.shape == want.shape and err <= 1e-5, f"stft(window=hamming, center={center}): {tuple(got.shape)}, err {err:.3e}")
        print(f"stft(window=hamming, center={center}) {tuple(got.shape)}: card vs host {err:.3e} of each frame's largest magnitude")
    spec = stft(host, n_fft, hop, window=win)
    want = istft(spec, n_fft, hop, n, window=win)
    got = istft(spec.cuda(), n_fft, hop, n, window=win).cpu()
    err, trip = float((got - want).abs().max()), float((got - host).abs().max())
    check(got.shape == host.shape and err <= 1e-5 and trip <= 1e-5, f"istft(window=hamming): card vs host {err:.3e}, vs the signal {trip:.3e}")
    print(f"istft(window=hamming) {tuple(got.shape)}: card vs host {err:.3e}, round trip vs the signal {trip:.3e} (absolute)")

    checkpoints = Path(__file__).resolve().parent / "track_analyser_tpu" / "models" / "checkpoints"
    for name in ("downbeat_tcn_v2.npz", "downbeat_tcn_v1.npz", "downbeat_v1.npz"):
        params = downbeat_net.load_checkpoint(checkpoints / name)
        n_mels = params["tcn_in_w" if "tcn0_w" in params else "in_w"].shape[0]
        feats = torch.from_numpy(rng.standard_normal((4_096, n_mels)).astype(np.float32))
        want = downbeat_net.forward(params, feats)
        got = downbeat_net.forward(params, feats.cuda())
        err = float((got.cpu() - want).abs().max())
        check(got.is_cuda and got.shape == (4_096, 3) and err <= 1e-4, f"downbeat_net.forward({name}): {tuple(got.shape)}, err {err:.3e}")
        print(f"downbeat_net.forward({name}) (4096, 3): card vs host {err:.3e} (absolute)")

    env = np.abs(rng.standard_normal((2, 16_385))).astype(np.float32)
    for y in (env[0], env):
        want = onset.autocorrelate(torch.from_numpy(y))
        got = onset.autocorrelate(torch.from_numpy(y).cuda()).cpu()
        err = float(((got - want).abs() / want[..., :1]).max())
        check(got.shape == y.shape and err <= 1e-5, f"autocorrelate {y.shape}: err {err:.3e} of ac[..., 0]")
        print(f"autocorrelate {y.shape}: card vs host {err:.3e} of ac[..., 0]")

    check(binding.available() is True and binding.has_transport() is True, "native binding: not available")
    check(native_build.build(verbose=False) is True, "native.build.build() returned False")
    print("native: available() True, has_transport() True, build(verbose=False) True")
    print(f"phase 18: {time.perf_counter() - t_phase:.1f} s -- {card}")


MESH_RUNS = 2  # timed runs of each (device_batch, workers) setting in phase 19
WORKER = "analyse_library-worker"  # the sweep's dispatch threads are named so


@contextlib.contextmanager
def recording_dispatches(batch_module):
    """Record (dispatch thread, device) of every chunk that
    ``batch._dispatch`` runs inside the block."""

    real = batch_module._dispatch
    seen: list = []
    lock = threading.Lock()

    def recorded(transport, staged, **kwargs):
        with lock:
            seen.append((threading.current_thread().name, str(staged[1].device)))
        return real(transport, staged, **kwargs)

    batch_module._dispatch = recorded
    try:
        yield seen
    finally:
        batch_module._dispatch = real


def mesh_phase(card: str, launches: "Launches", path_launches: dict, sources: "list[str]",
               lengths: "list[int]", good: "list[int]") -> None:
    """Phase 19: ``analyse_library(mesh=["cuda:0", "cuda:0"])``, two
    dispatch workers on the one card, on phase 7's library through both
    STFT routes at ``device_batch`` 1 and SWEEP_BATCH: outcomes in source
    order, launches equal to chunks, both workers used, lanes against
    batch-1 ``analyse_track`` (bit for bit at batch 1), the manifest's
    resume; a kernel failure injected into worker 1 (eager), a replay
    that fails in worker 1 and a capture that fails each propagate and
    leave no thread running; the 40-source library timed with one worker and
    with two; with more than one card, the default mesh over all of
    them."""

    import torch

    from track_analyser_tpu_torch import analyse_track
    from track_analyser_tpu_torch.ops import median
    from track_analyser_tpu_torch.parallel import batch
    from track_analyser_tpu_torch.pipeline import TrackAnalysisResult

    phase("19 library sweep over a mesh: analyse_library(mesh=['cuda:0', 'cuda:0']), two workers on one card")
    t_phase = time.perf_counter()
    n_cards = torch.cuda.device_count()
    print(f"visible cards: {n_cards}")
    two = ["cuda:0", "cuda:0"]

    def sweep(label: str, lanes: int, mesh, singles: dict, fused: bool, manifest=None) -> list:
        """One sweep of the library, held to its launches, order and lanes."""

        chunks = sweep_chunks(lengths, lanes)
        launches.reset()
        with recording_dispatches(batch) as seen:
            outcome, ms = wall_ms(lambda: batch.analyse_library(
                sources, device="cuda", mesh=mesh, transport="ms", device_batch=lanes, manifest_path=manifest
            ))
        counts = launches.read()
        path_launches[label] = counts
        expected = {"median31_time": chunks, "median31_freq": chunks, "stft_magnitude": chunks if fused else 0}
        check(counts == expected, f"{label}: launches {counts}, expected {expected}")
        workers = sorted({name.rsplit("_", 1)[0] for name, _dev in seen})
        share = {d: sum(dev == d for _n, dev in seen) for d in sorted({dev for _n, dev in seen})}
        check(len(seen) == chunks and len(workers) == min(chunks, len(mesh or range(n_cards))),
              f"{label}: {len(seen)} dispatches by {workers}, expected {chunks} chunks over every worker")
        check(len(outcome) == len(sources), f"{label}: {len(outcome)} outcomes for {len(sources)} sources")
        for i, item in enumerate(outcome):
            if i not in good:
                check(isinstance(item, batch.TrackFailure) and item.source == sources[i], f"{label}: source {i} gave {item}")
                continue
            check(isinstance(item, TrackAnalysisResult) and item.audio.path == sources[i],
                  f"{label}: source {i} gave {type(item).__name__} for {getattr(getattr(item, 'audio', None), 'path', None)}")
            if lanes == 1:
                fields = differing_fields(item, singles[i])
                check(not fields, f"{label}: source {i} not bit-identical to batch-1 analyse_track: {fields}")
            else:
                compare_results(item, singles[i], f"{label}, source {i} vs analyse_track", rounding_differs=True)
        print(
            f"{label}: {ms:.1f} ms wall, {chunks} chunks dealt to workers {workers}, chunks per card {json.dumps(share)}, "
            f"launches {json.dumps(counts)}; outcomes in source order; lanes "
            f"{'bit-identical to' if lanes == 1 else 'within compare_results of'} batch-1 analyse_track -- {card}"
        )
        return outcome

    with tempfile.TemporaryDirectory() as tmp:
        for route, fused in (("cufft", False), ("fused_stft", True)):
            if fused:
                os.environ["TA_PALLAS_STFT"] = "1"
            try:
                singles = {i: analyse_track(sources[i], transport="ms", device="cuda") for i in good}
                for lanes in (1, SWEEP_BATCH):
                    manifest = Path(tmp) / f"manifest_{route}_{lanes}.jsonl"
                    sweep(f"mesh sweep, 2 workers on cuda:0 ({route}, device_batch {lanes})", lanes, two, singles, fused, manifest)
                    rerun = batch.analyse_library(sources, device="cuda", mesh=two, transport="ms", manifest_path=manifest)
                    for i, item in enumerate(rerun):
                        want = batch.SkippedTrack if i in good else batch.TrackFailure
                        check(isinstance(item, want), f"mesh rerun {route} {lanes}: source {i} gave {type(item).__name__}")
                print(f"mesh reruns ({route}) with their manifests: done sources skipped, the failed one retried")
                if n_cards >= 2 and not fused:
                    # The default mesh: every visible card, one worker each.
                    for lanes in (1, SWEEP_BATCH):
                        for i in range(n_cards):
                            torch.cuda.reset_peak_memory_stats(i)
                        sweep(f"default mesh over {n_cards} cards ({route}, device_batch {lanes})", lanes, None, singles, fused)
                        peaks = {f"cuda:{i}": round(torch.cuda.max_memory_allocated(i) / 2**20) for i in range(n_cards)}
                        print(f"default mesh, device_batch {lanes}: peak device memory MiB per card {json.dumps(peaks)} -- {card}")
            finally:
                os.environ.pop("TA_PALLAS_STFT", None)
        if n_cards < 2:
            print(f"default mesh over several cards: not run ({n_cards} visible card)")

        # A kernel failure in worker 1: its second chunk's first median
        # launch reports a CUDA error, as a failed launch would. The sweep
        # runs eagerly (TRACK_ANALYSER_TPU_DEBUG_NANS=1), since a replayed
        # graph launches its medians without the wrapper.
        real_library = median._library
        calls: dict = {}

        class FailingLaunch:
            def __init__(self, lib):
                self.lib = lib

            def median31_launch(self, *args):
                name = threading.current_thread().name
                calls[name] = calls.get(name, 0) + 1
                if name.startswith(f"{WORKER}1") and calls[name] == 3:
                    return 700  # cudaErrorIllegalAddress
                return self.lib.median31_launch(*args)

        median._library = lambda: FailingLaunch(real_library())
        os.environ["TRACK_ANALYSER_TPU_DEBUG_NANS"] = "1"
        before = set(threading.enumerate())
        raised = None
        try:
            batch.analyse_library(sources, device="cuda", mesh=two, transport="ms", device_batch=1)
        except RuntimeError as exc:
            raised = exc
        finally:
            median._library = real_library
            del os.environ["TRACK_ANALYSER_TPU_DEBUG_NANS"]
        torch.cuda.synchronize()
        check(raised is not None and "CUDA error 700" in str(raised), f"the failure injected into worker 1 did not propagate: {raised!r}")
        left = [t.name for t in set(threading.enumerate()) - before if t.is_alive()]
        check(not left, f"threads left running after the failed sweep: {left}")
        print(f"failure injected into worker 1's second chunk: analyse_library raised {raised!r}; no thread left running")

        def failing_sweep(label: str, expected: str) -> None:
            """A sweep on the main path, whose injected failure must come
            out of analyse_library and leave no thread running."""

            before = set(threading.enumerate())
            raised = None
            try:
                batch.analyse_library(sources, device="cuda", mesh=two, transport="ms", device_batch=1)
            except RuntimeError as exc:
                raised = exc
            torch.cuda.synchronize()
            check(raised is not None and expected in str(raised), f"the failure injected into {label} did not propagate: {raised!r}")
            left = [t.name for t in set(threading.enumerate()) - before if t.is_alive()]
            check(not left, f"threads left running after the failed sweep: {left}")
            print(f"failure injected into {label}: analyse_library raised {raised!r}; no thread left running")

        # A replay that fails in worker 1: its second replay raises, as a
        # failed graph launch would. A clean sweep first captures every key,
        # so that each of the sweep's chunks replays.
        batch.analyse_library(sources, device="cuda", mesh=two, transport="ms", device_batch=1)
        real_replay = torch.cuda.CUDAGraph.replay
        replays: dict = {}

        def failing_replay(graph):
            name = threading.current_thread().name
            replays[name] = replays.get(name, 0) + 1
            if name.startswith(f"{WORKER}1") and replays[name] == 2:
                raise RuntimeError("CUDA error: an illegal memory access was encountered (injected into a replay)")
            return real_replay(graph)

        torch.cuda.CUDAGraph.replay = failing_replay
        try:
            failing_sweep("worker 1's second replay", "injected into a replay")
        finally:
            torch.cuda.CUDAGraph.replay = real_replay

        # A capture that fails: with no graph captured, the first chunk's
        # capture meets a median launch that reports a CUDA error.
        class FailingCapture:
            def __init__(self, lib):
                self.lib = lib

            def median31_launch(self, *args):
                if torch.cuda.is_current_stream_capturing():
                    return 700  # cudaErrorIllegalAddress
                return self.lib.median31_launch(*args)

        batch.clear_graphs()
        median._library = lambda: FailingCapture(real_library())
        try:
            failing_sweep("the first chunk's capture", "CUDA error 700")
        finally:
            median._library = real_library

        # Throughput: the 40-source library with one worker and with two on
        # the one card, alternating, MESH_RUNS timed runs each (phase 7
        # warmed every bucket).
        long_library = []
        for copy in range(THROUGHPUT_COPIES):
            for i in good:
                link = Path(tmp) / f"copy{copy}_{Path(sources[i]).name}"
                os.link(sources[i], link)
                long_library.append(str(link))
        n_tracks = len(long_library)
        settings = [(lanes, workers) for lanes in (1, SWEEP_BATCH) for workers in (1, 2)]
        walls = {s: [] for s in settings}
        stages = {s: {} for s in settings}
        peaks = {s: 0.0 for s in settings}
        for _rep in range(MESH_RUNS):
            for lanes, workers in settings:
                batch.reset_stage_seconds()
                torch.cuda.reset_peak_memory_stats(0)
                outcome, ms = wall_ms(lambda: batch.analyse_library(
                    long_library, device="cuda", mesh=["cuda:0"] * workers, transport="ms", device_batch=lanes
                ))
                check(all(isinstance(item, TrackAnalysisResult) for item in outcome),
                      f"mesh throughput, {workers} worker(s), device_batch {lanes}: a track did not analyse")
                walls[(lanes, workers)].append(ms / 1e3)
                for k, v in batch.stage_seconds().items():
                    stages[(lanes, workers)][k] = stages[(lanes, workers)].get(k, 0.0) + v
                peaks[(lanes, workers)] = max(peaks[(lanes, workers)], torch.cuda.max_memory_allocated(0) / 2**20)
    for lanes, workers in settings:
        runs = walls[(lanes, workers)]
        med = statistics.median(runs)
        per_track = {k: round(v * 1e3 / (MESH_RUNS * n_tracks), 3) for k, v in sorted(stages[(lanes, workers)].items())}
        print(
            f"mesh throughput, device_batch {lanes}, {workers} worker(s) on cuda:0, {n_tracks} tracks, {MESH_RUNS} runs: "
            f"wall s {[round(w, 3) for w in runs]}; median {med:.3f} s, {med / n_tracks * 1e3:.1f} ms per track, "
            f"{n_tracks / med * 3600:.0f} tracks per card-hour; stage ms per track (summed over threads) "
            f"{json.dumps(per_track)}; peak device memory cuda:0 {peaks[(lanes, workers)]:.0f} MiB -- {card}"
        )
    for lanes in (1, SWEEP_BATCH):
        one, two_w = (statistics.median(walls[(lanes, w)]) for w in (1, 2))
        print(f"device_batch {lanes}: two workers against one, median wall {two_w / one:.3f}x -- {card}")
    print(f"phase 19: {time.perf_counter() - t_phase:.1f} s -- {card}")


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SmokeFailure("torch.cuda.is_available() is false: this smoke run needs a CUDA card")

    from track_analyser_tpu_torch import analyse_track
    from track_analyser_tpu_torch.device import resolve_device
    from track_analyser_tpu_torch.io import write_wav
    from track_analyser_tpu_torch.ops import cuda_build, fused_stft, median
    from track_analyser_tpu_torch.ops.filters import reflect_index
    from track_analyser_tpu_torch.ops.stft import magnitude
    from track_analyser_tpu_torch.parallel import batch
    from track_analyser_tpu_torch.pipeline import TrackAnalysisResult
    from track_analyser_tpu_torch.utils import AudioInput, coerce_audio

    wall_start = time.perf_counter()
    launches = Launches()
    path_launches: dict = {}  # main path -> {kernel: launches}

    # ---- 1. environment ----------------------------------------------------
    phase("1 environment")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    card = f"{smi} (nvidia-smi name, power.limit)"
    max_clock_mhz = float(
        subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, check=True,
        ).stdout.strip().splitlines()[0]
    )
    nvcc = subprocess.run([cuda_build.nvcc(), "--version"], capture_output=True, text=True, check=True)
    dev = resolve_device("cuda")  # full float32 (TF32 off) for every plain version too
    print("python", sys.version.split()[0], "| torch", torch.__version__, "| torch.version.cuda", torch.version.cuda)
    print("device", torch.cuda.get_device_name(0), "| count", torch.cuda.device_count())
    print("card:", card, f"| max SM clock {max_clock_mhz:.0f} MHz")
    print("nvcc:", nvcc.stdout.strip().splitlines()[-1])
    cpu = host_cpu()
    print("host CPU:", cpu)
    minmax_per_s = MINMAX_PER_SM_CLOCK * SMS * max_clock_mhz * 1e6

    # ---- 2. build ----------------------------------------------------------
    phase("2 build: one nvcc per CUDA source and the native host libraries (g++), all started together")
    from concurrent.futures import ThreadPoolExecutor

    from track_analyser_tpu_torch.native import build as native_build

    def timed(fn):
        t = time.perf_counter()
        return fn(), time.perf_counter() - t

    ffmpeg_absent = native_build.ffmpeg_absent_reason()
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=3) as pool:
        cuda_job = pool.submit(timed, cuda_build.build_all)
        native_job = pool.submit(timed, native_build.build_native)
        ffmpeg_job = pool.submit(timed, native_build.build_ffmpeg) if ffmpeg_absent is None else None
        built, cuda_s = cuda_job.result()
        (native_path, _log), native_s = native_job.result()  # a failed build raises with the compiler's log
        ffmpeg_built = ffmpeg_job.result() if ffmpeg_job is not None else None
    print(f"built {', '.join(p.name for p, _ in built.values())} in {cuda_s:.2f} s")
    print(f"libta_native: {native_path.name} built in {native_s:.2f} s ({native_build.cxx()} {' '.join(native_build.FLAGS)})")
    if ffmpeg_built is None:
        print(f"libta_ffmpeg: absent ({ffmpeg_absent})")
    else:
        print(f"libta_ffmpeg: {ffmpeg_built[0][0].name} built in {ffmpeg_built[1]:.2f} s")
    print(f"phase 2 wall: {time.perf_counter() - t0:.2f} s")
    for source, (_path, log) in built.items():
        print(f"{source}:", "\n".join(l for l in log.splitlines() if "ptxas info" in l or "spill" in l) or "(cached)")
    stft_blocks_per_sm = fused_stft.blocks_per_sm()
    print(f"stft_mag.cu: {stft_blocks_per_sm} block(s) of the kernel per SM")

    # ---- 3. median kernel vs plain on the card -------------------------------
    phase("3 median31 kernel vs plain PyTorch on the card")
    gen = torch.Generator(device="cuda").manual_seed(0)
    errs = {}
    batch_shape = (SWEEP_BATCH,) + MAIN_SHAPE
    for axis in (-1, -2):
        r, per_output = median_network(axis)
        print(f"{REPLACES[axis][0]}: runs of {r} outputs a thread, {per_output:g} min/max per output (ops/median.tile_network)")
    # Uniform values, and tie-heavy ones: 8 levels with exact zeros. (7, 20),
    # (40, 9) and (1, 5) are shorter than the window: the reflection bounces.
    for shape in (MAIN_SHAPE, batch_shape, (33, 513), (1025, 65), (2, 1025, 4097), (7, 20), (40, 9), (1, 5), (3, 33, 100)):
        for values in ("uniform", "8 levels"):
            x = torch.rand(shape, device="cuda", generator=gen)
            if values == "8 levels":
                x = torch.floor(x * 8) / 8
            for axis in (-1, -2):
                got = median.median31(x, axis)
                ref = median.median31_reference(x, axis)
                torch.cuda.synchronize()
                err = float((got - ref).abs().max())
                errs[axis] = max(errs.get(axis, 0.0), err)
                check(torch.equal(got, ref), f"median31 axis {axis} shape {shape} ({values}): max |diff| {err}")
                print(f"shape {shape} axis {axis} ({values}): bit-identical")
            del x, got, ref
    median_timings = {}
    for shape in (MAIN_SHAPE, batch_shape):
        x = torch.rand(shape, device="cuda", generator=gen)
        for axis in (-1, -2):
            kernel_ms = time_cuda_ms(lambda: median.median31(x, axis), launches=MEDIAN_TIMED_LAUNCHES)
            plain_ms = time_cuda_ms(lambda: median.median31_reference(x, axis), reps=5, warmup=1)
            # The library call: one unchunked unfold + median over a
            # reflect-padded copy (the copy is made outside the timing).
            padded = x.index_select(axis, reflect_index(x.shape[axis], 15, 15, x.device))
            def library():
                return padded.unfold(axis, 31, 1).median(dim=-1).values

            check(torch.equal(library(), median.median31(x, axis)), f"median library call at {shape} axis {axis}")
            library_ms = time_cuda_ms(library, reps=5, warmup=1)
            del padded
            b = median_bound(x.numel(), axis, minmax_per_s)
            one_call_ms = time_cuda_ms(lambda: median.median31(x, axis))
            median_timings[(shape, axis)] = {"ms": kernel_ms, "one_call_ms": one_call_ms, "plain_ms": plain_ms, "library_ms": library_ms, **b}
            gbps = 2 * x.numel() * 4 / (kernel_ms * 1e-3) / 1e9
            print(
                f"{REPLACES[axis][0]} at {shape}: kernel {kernel_ms:.4f} ms ({gbps:.0f} GB/s of one read + "
                f"one write; {MEDIAN_TIMED_LAUNCHES} launches back to back), one call with its launch gap "
                f"{one_call_ms:.4f} ms, plain {plain_ms:.4f} ms, library call (unfold + median, unchunked) "
                f"{library_ms:.4f} ms, {bound_shares(b, kernel_ms)} -- {card}"
            )
        del x

    # ---- 4. single-track path ---------------------------------------------
    phase("4 main path: analyse_track on a 181 s WAV (transport auto = ms)")
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "track_181s.wav"
        main_track = make_track(SECONDS)
        write_wav(path, main_track, SR)
        results, walls = [], []
        torch.cuda.reset_peak_memory_stats()
        launches.reset()
        for label in ("cold", "warm"):
            before = launches.read()
            t0 = time.perf_counter()
            result = analyse_track(str(path), device="cuda")
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            after = launches.read()
            expected = {"median31_time": 1, "median31_freq": 1, "stft_magnitude": 0}
            check(
                all(after[k] - before[k] == v for k, v in expected.items()),
                f"{label} run: launches went {before} -> {after}, expected +{expected}",
            )
            results.append(result)
            print(f"{label} analyse_track: {walls[-1] * 1e3:.1f} ms wall -- {card}")
        path_launches["analyse_track (2 calls)"] = launches.read()
        peak_mb = torch.cuda.max_memory_allocated() / 2**20
        t0 = time.perf_counter()
        audio = coerce_audio(str(path))
        decode_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        analyse_track(audio, device="cuda")
        torch.cuda.synchronize()
        preloaded_ms = (time.perf_counter() - t0) * 1e3
        float32_ms = []
        for _ in range(2):  # the first call warms the float32 bucket's plans
            t0 = time.perf_counter()
            analyse_track(str(path), device="cuda", transport="float32")
            torch.cuda.synchronize()
            float32_ms.append((time.perf_counter() - t0) * 1e3)
    print(
        f"warm split: WAV decode {decode_ms:.1f} ms; analyse_track on the decoded "
        f"AudioInput {preloaded_ms:.1f} ms -- {card}"
    )
    print(
        f"warm analyse_track(path): transport ms {walls[-1] * 1e3:.1f} ms, float32 "
        f"{float32_ms[-1]:.1f} ms (its first call {float32_ms[0]:.1f} ms) -- {card}"
    )
    print(f"launches over the two ms calls: {json.dumps(path_launches['analyse_track (2 calls)'])}")
    print(f"peak device memory allocated: {peak_mb:.0f} MiB")
    result = main_result = results[-1]
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
    excerpt = with_noise_floor(make_track(30.0, bpm=126.0, seed=11), 5)
    audio = AudioInput(samples=excerpt.mean(axis=0), sample_rate=SR, stereo_samples=excerpt)
    on_gpu = analyse_track(audio, device="cuda")
    on_cpu = analyse_track(audio, device="cpu")
    # The excerpt's bar-position path has a slip (a shortened bar), so the
    # decoder ties exactly there, and the card's and the host's rounding
    # (which differ from one machine to the next) pick between the tied paths.
    compare_results(on_gpu, on_cpu, rounding_differs=True)
    print("gpu and cpu results agree on every field")

    # ---- 6. fused STFT kernel vs plain and cuFFT on the card ----------------
    phase("6 fused |STFT| kernel vs plain PyTorch and cuFFT on the card")
    stft_err = stft_abs_err = 0.0

    def hold_stft(label: str, y) -> "torch.Tensor":
        """One launch on ``y`` held against the plain version and cuFFT."""

        nonlocal stft_err, stft_abs_err
        before = fused_stft.stft_magnitude.launches
        got = fused_stft.stft_magnitude(y, 2048, 512)
        torch.cuda.synchronize()
        check(fused_stft.stft_magnitude.launches == before + 1, f"stft {label}: no launch counted")
        plain = fused_stft.stft_magnitude_reference(y, 2048, 512)
        cufft = magnitude(y if y.dim() == 2 else y[None], 2048, 512)
        channels = y.shape[0] if y.dim() == 2 else 1
        want = (channels, 1025, 1 + y.shape[-1] // 512)
        check(tuple(got.shape) == want == tuple(plain.shape) == tuple(cufft.shape), f"stft {label}: shape {tuple(got.shape)}, expected {want}")
        check(got.is_contiguous(), f"stft {label}: output not contiguous")
        check(bool(torch.isfinite(got).all()), f"stft {label}: not finite")
        e_plain, e_fft = frame_norm_err(got, plain), frame_norm_err(got, cufft)
        stft_err = max(stft_err, e_plain, e_fft)
        stft_abs_err = max(stft_abs_err, float((got - plain).abs().max()))
        check(e_plain < STFT_TOL and e_fft < STFT_TOL, f"stft {label}: frame-norm error {e_plain}, {e_fft}")
        print(f"stft {label} -> {tuple(got.shape)}: frame-norm error vs plain {e_plain:.3e}, vs cuFFT {e_fft:.3e}")
        return got

    ragged = 44_100 * 3 + 1_234  # no hop multiple
    for shape in ((2, BUCKET), (2 * SWEEP_BATCH, BUCKET), (2, ragged), (1, 1 << 15), (44_100,), (1_000,), (2 * SWEEP_BATCH, ragged)):
        hold_stft(str(shape), torch.randn(shape, device="cuda", generator=gen) * 0.3)
    strided = (torch.randn((3, 2 * ragged), device="cuda", generator=gen) * 0.3)[:, ::2]
    check(not strided.is_contiguous(), "the strided input is contiguous")
    hold_stft(f"strided {tuple(strided.shape)}", strided)
    # An impulse at sample 5000: every frame that holds it is flat over the
    # bins, at the window's value there.
    impulse = torch.zeros((1, 20_000), device="cuda")
    impulse[0, 5_000] = 1.0
    got = hold_stft("impulse", impulse)
    frame = 10  # centred at 5120: the impulse is its sample 904
    flat = 0.5 - 0.5 * math.cos(2.0 * math.pi * (5_000 - frame * 512 + 1_024) / 2048)
    spread = float((got[0, :, frame] - flat).abs().max())
    check(spread < STFT_TOL * flat * math.sqrt(1025), f"stft impulse: frame {frame} is not flat at {flat}: off by {spread}")
    # A tone on bin 100 (amplitude 0.5): a Hann window puts amplitude * 512
    # on the bin and half of it on each neighbour.
    tone = (0.5 * torch.cos(2.0 * math.pi * 100.0 / 2048 * torch.arange(65_536, device="cuda", dtype=torch.float64))).float()[None]
    got = hold_stft("tone", tone)
    inner = got[0, :, 4:-4]  # frames that lie wholly inside the signal
    norm = float(torch.linalg.vector_norm(inner, dim=0).max())
    check(bool((inner.argmax(dim=0) == 100).all()), "stft tone: the peak is not on bin 100")
    for k, want in ((99, 128.0), (100, 256.0), (101, 128.0)):
        off = float((inner[k] - want).abs().max())
        check(off < STFT_TOL * norm, f"stft tone: bin {k} is off {want} by {off}")
    print(f"stft impulse flat within {spread:.3e}; tone: bins 99, 100, 101 read 128, 256, 128 within {STFT_TOL * norm:.3e}")
    del got, inner, impulse, tone, strided

    stft_timings = {}
    for channels in (2, 2 * SWEEP_BATCH):
        y = torch.randn((channels, BUCKET), device="cuda", generator=gen) * 0.3
        frames, bins = 1 + BUCKET // 512, 1025
        kernel_ms = time_cuda_ms(lambda: fused_stft.stft_magnitude(y, 2048, 512), reps=10, warmup=2)
        plain_ms = time_cuda_ms(lambda: fused_stft.stft_magnitude_reference(y, 2048, 512), reps=5, warmup=1)
        library_ms = time_cuda_ms(lambda: magnitude(y, 2048, 512), reps=10, warmup=2)
        # The work, whichever kernel does it: the signal read once and the
        # magnitudes written once, and an FFT's operations per frame.
        flop = channels * frames * STFT_FLOP_PER_FRAME
        bound_ms, bound_by = bound(4 * channels * BUCKET + 4 * channels * bins * frames, flop / FP32_FLOP_PER_S)
        stft_timings[channels] = (kernel_ms, plain_ms, library_ms, bound_ms, bound_by)
        print(
            f"stft_magnitude at ({channels}, {BUCKET}): kernel {kernel_ms:.4f} ms, plain {plain_ms:.3f} ms, "
            f"cuFFT ops/stft.magnitude {library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}); the bound is "
            f"{100 * bound_ms / kernel_ms:.1f}% of the kernel's time, the kernel's time {kernel_ms / library_ms:.3f}x "
            f"cuFFT's; {stft_blocks_per_sm} block(s) per SM -- {card}"
        )
        del y

    # ---- 7. library sweep ----------------------------------------------------
    phase(f"7 library sweep: analyse_library(transport='ms', device_batch={SWEEP_BATCH})")
    # The library stays on disk for phases 12, 13 and 19.
    library_dir = tempfile.TemporaryDirectory()
    sources, lengths, good = write_library(Path(library_dir.name))
    chunks = sweep_chunks(lengths, SWEEP_BATCH)
    print(f"{len(sources)} sources, {len(good)} decodable -> {chunks} chunks at device_batch {SWEEP_BATCH}")
    with tempfile.TemporaryDirectory() as tmp:

        sweeps, sweep_walls, sweep_peak_mib = {}, {}, {}
        for label, fused in (("fused_stft", True), ("cufft", False)):
            manifest = Path(tmp) / f"manifest_{label}.jsonl"
            if fused:
                os.environ["TA_PALLAS_STFT"] = "1"
            else:
                os.environ.pop("TA_PALLAS_STFT", None)
            launches.reset()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            outcome = batch.analyse_library(
                sources, device="cuda", transport="ms", device_batch=SWEEP_BATCH, manifest_path=manifest
            )
            torch.cuda.synchronize()
            sweep_walls[label] = time.perf_counter() - t0
            sweep_peak_mib[label] = torch.cuda.max_memory_allocated() / 2**20
            counts = launches.read()
            os.environ.pop("TA_PALLAS_STFT", None)
            path_launches[f"sweep ({label})"] = counts
            print(f"sweep {label}: {sweep_walls[label]:.3f} s wall, launches {json.dumps(counts)} -- {card}")
            expected = {"median31_time": chunks, "median31_freq": chunks, "stft_magnitude": chunks if fused else 0}
            check(counts == expected, f"sweep {label}: launches {counts}, expected {expected}")
            check(len(outcome) == len(sources), f"sweep {label}: {len(outcome)} outcomes for {len(sources)} sources")
            for i, item in enumerate(outcome):
                want = TrackAnalysisResult if i in good else batch.TrackFailure
                check(isinstance(item, want), f"sweep {label}: source {i} gave {type(item).__name__}")
            sweeps[label] = outcome
            bpm = outcome[0].beat.bpm
            check(abs(bpm - BPM) <= 0.1, f"sweep {label}: bpm {bpm} not within 0.1 of {BPM}")
            print(f"sweep {label}: outcomes by source OK, 118-BPM track reads {bpm:.4f}")

            rerun = batch.analyse_library(sources, device="cuda", transport="ms", manifest_path=manifest)
            for i, item in enumerate(rerun):
                want = batch.SkippedTrack if i in good else batch.TrackFailure
                check(isinstance(item, want), f"rerun {label}: source {i} gave {type(item).__name__}")
            print(f"rerun {label} with its manifest: done sources skipped, the failed one retried")

        print(
            f"peak device memory of a sweep at device_batch {SWEEP_BATCH}: {sweep_peak_mib['fused_stft']:.0f} MiB with "
            f"the fused STFT kernel, {sweep_peak_mib['cufft']:.0f} MiB with cuFFT -- {card}"
        )

        # A lane of a batch-4 graph and the fused-STFT graph round
        # differently from a batch-1 cuFFT graph (other GEMM and FFT plans):
        # compare_results then admits an exact Viterbi tie in bar positions.
        singles = {}
        for i in good:
            single = singles[i] = analyse_track(sources[i], transport="ms", device="cuda")
            lane = f"sweep lane {i} ({Path(sources[i]).name})"
            compare_results(sweeps["cufft"][i], single, f"{lane} vs analyse_track", rounding_differs=True)
            compare_results(
                sweeps["fused_stft"][i], sweeps["cufft"][i], f"fused-STFT vs cuFFT, {lane}", rounding_differs=True
            )
            print(
                f"{lane}: fields not bit-identical to batch-1 analyse_track: "
                f"{differing_fields(sweeps['cufft'][i], single) or 'none'}; to the fused-STFT sweep: "
                f"{differing_fields(sweeps['fused_stft'][i], sweeps['cufft'][i]) or 'none'}"
            )
        print("every lane agrees with its batch-1 analyse_track and across the two sweeps")

        # Throughput on a library long enough that pipeline fill and drain
        # are a small part of a run: the decodable WAVs linked
        # THROUGHPUT_COPIES times over. device_batch 1 and 4 alternate, one
        # warm-up run each, then THROUGHPUT_RUNS timed runs each. After the
        # last runs, every batch-1 result must equal its track's
        # analyse_track bit for bit (the readback of chunks in flight is
        # ordered right), and the batch-4 copies of a track are counted
        # against each other (their chunk mates differ).
        long_library, track_of = [], []
        for copy in range(THROUGHPUT_COPIES):
            for i in good:
                link = Path(tmp) / f"copy{copy}_{Path(sources[i]).name}"
                os.link(sources[i], link)
                long_library.append(str(link))
                track_of.append(i)
        n_tracks = len(long_library)
        lane_settings = (1, SWEEP_BATCH)
        run_walls = {lanes: [] for lanes in lane_settings}
        stage_sums = {lanes: {} for lanes in lane_settings}
        peak_mib = {lanes: 0.0 for lanes in lane_settings}
        for rep in range(THROUGHPUT_RUNS + 1):
            for lanes in lane_settings:
                batch.reset_stage_seconds()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                outcome = batch.analyse_library(long_library, device="cuda", transport="ms", device_batch=lanes)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                check(
                    all(isinstance(item, TrackAnalysisResult) for item in outcome),
                    f"throughput sweep, device_batch {lanes}: a track did not analyse",
                )
                if rep == 0:
                    continue
                run_walls[lanes].append(wall)
                for k, v in batch.stage_seconds().items():
                    stage_sums[lanes][k] = stage_sums[lanes].get(k, 0.0) + v
                peak_mib[lanes] = max(peak_mib[lanes], torch.cuda.max_memory_allocated() / 2**20)
                if rep < THROUGHPUT_RUNS:
                    continue
                if lanes == 1:
                    for j, item in enumerate(outcome):
                        fields = differing_fields(item, singles[track_of[j]])
                        check(not fields, f"throughput sweep, batch 1, source {j}: not bit-identical to analyse_track: {fields}")
                    print(f"last batch-1 throughput run: all {n_tracks} results bit-identical to analyse_track")
                else:
                    first = {}
                    for j, item in enumerate(outcome):
                        first.setdefault(track_of[j], item)
                    same = sum(not differing_fields(item, first[track_of[j]]) for j, item in enumerate(outcome))
                    print(
                        f"last batch-{lanes} throughput run: {same} of {n_tracks} results bit-identical to the "
                        f"first copy of their track in the run"
                    )
        quartiles = {}
        for lanes in lane_settings:
            q1, med, q3 = (float(q) for q in np.percentile(run_walls[lanes], [25, 50, 75]))
            quartiles[lanes] = (q1, med, q3)
            stages = {k: round(v * 1e3 / (THROUGHPUT_RUNS * n_tracks), 3) for k, v in sorted(stage_sums[lanes].items())}
            print(
                f"sweep throughput, device_batch {lanes}, {n_tracks} tracks, {THROUGHPUT_RUNS} warm runs: "
                f"wall s {[round(w, 3) for w in run_walls[lanes]]}; median {med:.3f} s (quartiles {q1:.3f} - {q3:.3f}); "
                f"{med / n_tracks * 1e3:.1f} ms per track ({q1 / n_tracks * 1e3:.1f} - {q3 / n_tracks * 1e3:.1f}); "
                f"{n_tracks / med * 3600:.0f} tracks per card-hour; stage ms per track (summed over threads) "
                f"{json.dumps(stages)}; peak device memory {peak_mib[lanes]:.0f} MiB -- {card}"
            )
        (a1, m1, b1), (a4, m4, b4) = quartiles[1], quartiles[SWEEP_BATCH]
        print(
            f"device_batch {SWEEP_BATCH} against 1: median wall {m4 / m1:.3f}x; "
            f"interquartile ranges {'overlap' if a4 <= b1 and a1 <= b4 else 'do not overlap'} -- {card}"
        )
    print(f"chip_smoke wall so far: {time.perf_counter() - wall_start:.1f} s")

    # ---- 8. median kernel at the DSP separator's shape ---------------------
    phase(f"8 median31 kernel at the DSP separator's shape {STEMS_SHAPE}")
    x = torch.rand(STEMS_SHAPE, device="cuda", generator=gen)
    stems_median = {}
    for axis in (-1, -2):
        got = median.median31(x, axis)
        ref = median.median31_reference(x, axis)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        errs[axis] = max(errs[axis], err)
        check(torch.equal(got, ref), f"median31 axis {axis} shape {STEMS_SHAPE}: max |diff| {err}")
        del got, ref
        kernel_ms = time_cuda_ms(lambda: median.median31(x, axis), launches=MEDIAN_TIMED_LAUNCHES)
        plain_ms = time_cuda_ms(lambda: median.median31_reference(x, axis), reps=5, warmup=1)
        b = median_bound(x.numel(), axis, minmax_per_s)
        stems_median[axis] = {"ms": kernel_ms, "plain_ms": plain_ms, **b}
        print(
            f"{REPLACES[axis][0]} at {STEMS_SHAPE}: bit-identical; kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"{bound_shares(b, kernel_ms)} -- {card}"
        )
    del x

    # ---- 9. stems at full width ---------------------------------------------
    phase("9 stems at full width: mask net v5, DSP separator, separate_stems on the 181 s stereo WAV")
    from track_analyser_tpu_torch.analysis import stems as stems_module
    from track_analyser_tpu_torch.io import decode_wav, load_audio
    from track_analyser_tpu_torch.models import separation, separation_net
    from track_analyser_tpu_torch.ops.stft import istft, stft
    from track_analyser_tpu_torch.substrate import pad_to_bucket

    stem_names = separation_net.STEMS
    no_median = {"median31_time": 0, "median31_freq": 0, "stft_magnitude": 0}
    once_per_axis = {"median31_time": 1, "median31_freq": 1, "stft_magnitude": 0}

    def hold_stems(label: str, stems: dict, like: np.ndarray) -> None:
        check(tuple(stems) == stem_names, f"{label}: stems {tuple(stems)}")
        for name, data in stems.items():
            check(data.shape == like.shape and data.dtype == np.float32, f"{label} {name}: shape {data.shape} {data.dtype}")
            check(bool(np.isfinite(data).all()), f"{label} {name}: not finite")

    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "track_181s.wav"
        write_wav(path, main_track, SR)
        samples, sr, _meta = load_audio(path, mono=False)
        check(samples.shape == main_track.shape and sr == SR, f"loader gave {samples.shape} at {sr} Hz")
        check(separation.model_name() == "bandsplit-masknet-v5", f"resolver names {separation.model_name()}")

        launches.reset()
        torch.cuda.reset_peak_memory_stats()
        net_runs, net_walls = [], []
        for _ in range(2):
            out, ms = wall_ms(lambda: separation.separate(samples, sr, device="cuda"))
            net_runs.append(out)
            net_walls.append(ms)
        net_peak_mib = torch.cuda.max_memory_allocated() / 2**20
        check(launches.read() == no_median, f"the mask net launched a kernel of the analysis path: {launches.read()}")
        hold_stems("mask net", net_runs[0], samples)
        check(all(np.array_equal(net_runs[0][k], net_runs[1][k]) for k in stem_names), "mask net: two runs differ")
        net = net_runs[0]
        del net_runs

        torch.cuda.reset_peak_memory_stats()
        dsp_runs, dsp_walls = [], []
        for _ in range(2):
            before = launches.read()
            out, ms = wall_ms(lambda: stems_module.separate_stems_arrays(samples, sr, device="cuda"))
            after = launches.read()
            check(
                all(after[k] - before[k] == v for k, v in once_per_axis.items()),
                f"DSP separator: launches went {before} -> {after}, expected +{once_per_axis}",
            )
            dsp_runs.append(out)
            dsp_walls.append(ms)
        dsp_peak_mib = torch.cuda.max_memory_allocated() / 2**20
        hold_stems("DSP separator", dsp_runs[0], samples)
        check(all(np.array_equal(dsp_runs[0][k], dsp_runs[1][k]) for k in stem_names), "DSP separator: two runs differ")
        dsp = dsp_runs[0]
        del dsp_runs
        off = float(np.abs(sum(dsp[k] for k in stem_names) - samples).max())
        check(off <= STEMS_TOL, f"DSP stems sum to the mixture within {off}, beyond {STEMS_TOL}")
        print(
            f"mask net: stems {samples.shape} finite, two runs bit-identical, no median launch; DSP separator: the "
            f"same, medians +1 per axis per call, stems sum to the mixture within {off:.2e}"
        )
        print(
            f"separation.separate wall {net_walls[0]:.1f} ms cold, {net_walls[1]:.1f} ms warm, peak device memory "
            f"{net_peak_mib:.0f} MiB; separate_stems_arrays wall {dsp_walls[0]:.1f} / {dsp_walls[1]:.1f} ms, peak "
            f"{dsp_peak_mib:.0f} MiB -- {card}"
        )

        launches.reset()
        bundle, stems_ms = wall_ms(lambda: stems_module.separate_stems(str(path), Path(tmp) / "stems", device="cuda"))
        check(bundle is not None and bundle.model_name == "bandsplit-masknet-v5", f"separate_stems gave {bundle}")
        check(launches.read() == once_per_axis, f"separate_stems: launches {launches.read()}, expected {once_per_axis}")
        check(tuple(bundle.stems) == stem_names, f"separate_stems wrote {tuple(bundle.stems)}")
        blend = {}
        worst = 0.0
        for name in stem_names:
            w = stems_module._BLEND_NEURAL_WEIGHT[name]
            blend[name] = (w * net[name] + (1.0 - w) * dsp[name]).astype(np.float32)
            written, wsr, meta = decode_wav(bundle.stems[name])
            check(written.shape == samples.shape and wsr == SR and meta["subtype"] == "PCM_16", f"{name}.wav: {written.shape} {wsr} {meta}")
            check(bool(np.isfinite(written).all()), f"{name}.wav: not finite")
            worst = max(worst, float(np.abs(written - np.clip(blend[name], -1.0, 1.0)).max()))
        check(worst <= 1.5 * PCM16_STEP, f"written stems are {worst} off the blend, beyond 1.5 / 32768")
        t0 = time.perf_counter()
        for name in stem_names:
            write_wav(Path(tmp) / f"again_{name}.wav", blend[name], SR, subtype="PCM_16")
        write_ms = (time.perf_counter() - t0) * 1e3
        print(
            f"separate_stems(path, dir): {stems_ms:.1f} ms wall, model {bundle.model_name}, four PCM_16 WAVs within "
            f"{worst * 32768:.3f} steps of the blend of the runs above; writing the four WAVs alone {write_ms:.1f} ms -- {card}"
        )
        del blend, written

        # The card against the host on the 30 s excerpt of phase 5.
        for label, fn in (
            ("mask net", lambda d: separation.separate(excerpt, SR, device=d)),
            ("DSP separator", lambda d: stems_module.separate_stems_arrays(excerpt, SR, device=d)),
        ):
            on_card, on_host = fn("cuda"), fn("cpu")
            hold_stems(f"{label}, excerpt", on_card, excerpt)
            off = max(float(np.abs(on_card[k] - on_host[k]).max()) for k in stem_names)
            check(off <= STEMS_TOL, f"{label}: card and host differ by {off} on the 30 s excerpt, beyond {STEMS_TOL}")
            print(f"{label} on the 30 s excerpt: card against host within {off:.2e} (limit {STEMS_TOL})")

        # Device times of the two separators and of their parts, on tensors
        # that already lie on the card.
        model = separation_net.params_from_jax(separation_net.load_checkpoint(separation._checkpoint_path())).to(dev)
        padded, f_valid = pad_to_bucket(samples, hop=separation_net.HOP)
        padded_dsp, f_valid_dsp = pad_to_bucket(samples, hop=stems_module._HOP)
        check(padded.shape == (2, BUCKET), f"bucket {padded.shape}")
        y = torch.from_numpy(padded).to(dev)
        y_dsp = torch.from_numpy(padded_dsp).to(dev)
        n_dsp = padded_dsp.shape[-1]
        run_net = lambda: separation_net.separate_signal_multi(model, y, n_samples=BUCKET, f_valid=f_valid)  # noqa: E731
        with torch.inference_mode():
            run_dsp = lambda: stems_module._dsp_separate_body(y_dsp, sr=SR, n_samples=n_dsp, f_valid=f_valid_dsp)  # noqa: E731
            net_dev_ms = time_cuda_ms(run_net, reps=5, warmup=1)
            dsp_dev_ms = time_cuda_ms(run_dsp, reps=5, warmup=1)
            spec = stft(y, 2048, 512)
            check(tuple(spec.shape) == (2,) + MAIN_SHAPE, f"net spectrogram {tuple(spec.shape)}")
            stft_ms = time_cuda_ms(lambda: stft(y, 2048, 512), reps=5, warmup=1)
            encode_ms = time_cuda_ms(lambda: model.encode(spec), reps=5, warmup=1)
            features_ms = time_cuda_ms(lambda: model.features(spec, f_valid), reps=5, warmup=1)
            h = model.features(spec, f_valid)
            decode_ms = time_cuda_ms(lambda: [model.decode_mask(h, name) for name in stem_names], reps=5, warmup=1)
            istft_net_ms = time_cuda_ms(lambda: istft(spec, 2048, 512, BUCKET, f_valid=f_valid), reps=5, warmup=1)
            del h, spec
            spec = stft(y_dsp, 4096, 1024)
            check(tuple(spec.shape) == STEMS_SHAPE, f"DSP spectrogram {tuple(spec.shape)}, expected {STEMS_SHAPE}")
            stft_dsp_ms = time_cuda_ms(lambda: stft(y_dsp, 4096, 1024), reps=5, warmup=1)
            istft_dsp_ms = time_cuda_ms(lambda: istft(spec, 4096, 1024, n_dsp, f_valid=f_valid_dsp), reps=5, warmup=1)
            del spec
            n_bands = len(model.bands)
            print(
                f"on the card at (2, {BUCKET}), CUDA events: mask net {net_dev_ms:.2f} ms = stft {stft_ms:.2f} + encoder and "
                f"{len(model.dilations)} mixing blocks {features_ms:.2f} (the {n_bands} per-band encoder GEMMs alone "
                f"{encode_ms:.2f}) + {4 * n_bands} per-band decoder GEMMs and masks {decode_ms:.2f} + 4 x (multiply, istft "
                f"{istft_net_ms:.2f}); DSP separator {dsp_dev_ms:.2f} ms, its stft {stft_dsp_ms:.2f}, its istft "
                f"{istft_dsp_ms:.2f} -- {card}"
            )
            profiled("mask net", run_net, card)
            profiled("DSP separator", run_dsp, card)
        del y, y_dsp, model

        # The main path with stems: medians once per axis in the fused graph
        # and once per axis in the DSP separator. Without output_dir the
        # stems go to ./stems, so the call runs inside the temporary directory.
        with contextlib.chdir(tmp):
            analyse_track(str(path), use_stems=True, device="cuda")  # warms this path's plans
            launches.reset()
            with_stems, with_stems_ms = wall_ms(lambda: analyse_track(str(path), use_stems=True, device="cuda"))
            path_launches["analyse_track(use_stems=True)"] = counts = launches.read()
        _plain, plain_call_ms = wall_ms(lambda: analyse_track(str(path), device="cuda"))
        expected = {"median31_time": 2, "median31_freq": 2, "stft_magnitude": 0}
        check(counts == expected, f"analyse_track(use_stems=True): launches {counts}, expected {expected}")
        check(
            with_stems.stems is not None and with_stems.stems.model_name == "bandsplit-masknet-v5"
            and all(p.exists() for p in with_stems.stems.stems.values()),
            f"analyse_track(use_stems=True): stems {with_stems.stems}",
        )
        check(not differing_fields(with_stems, _plain), "use_stems=True changed an analysis field")
        print(
            f"warm analyse_track(path, use_stems=True): {with_stems_ms:.1f} ms wall beside {plain_call_ms:.1f} ms for the "
            f"plain call; launches {json.dumps(counts)} -- {card}"
        )
    del net, dsp, samples

    # ---- 10. rendering -------------------------------------------------------
    phase("10 rendering: render_all, the tempogram graph, analyse_track(output_dir, use_stems=True)")
    import importlib.util

    from track_analyser_tpu_torch import report
    from track_analyser_tpu_torch.rendering import render_all

    def hold_artefacts(folder: Path, names, bpm: float) -> None:
        missing = [name for name in names if not (folder / name).is_file() or not (folder / name).stat().st_size]
        check(not missing, f"{folder.name}: missing or empty {missing}")
        data = json.loads((folder / "report.json").read_text())
        check(set(data) == set(REPORT_KEYS), f"report.json keys {sorted(data)}")
        for key, want in REPORT_KEYS.items():
            for item in data[key] if isinstance(data[key], list) else [data[key]]:
                check(set(item) == want, f"report.json {key}: keys {sorted(item)}")
        check(data["beat"]["bpm"] == bpm, f"report.json bpm {data['beat']['bpm']}, the result's {bpm}")
        check((folder / "hook.mid").read_bytes()[:4] == b"MThd", "hook.mid is no MIDI file")

    with tempfile.TemporaryDirectory() as tmp:
        tables = Path(tmp) / "tables"
        _out, render_ms = wall_ms(
            lambda: render_all(main_result, tables, report_request=report.ReportRequest(include_plots=False), device="cuda")
        )
        hold_artefacts(tables, TABLE_FILES, main_result.beat.bpm)
        check(not list(tables.glob("*.png")), "plots were written though none were asked for")
        print(f"render_all without plots: {sorted(p.name for p in tables.iterdir())} in {render_ms:.1f} ms")

        mono, f_valid = pad_to_bucket(main_track.mean(axis=0), hop=512)
        n_valid = main_track.shape[-1]
        with torch.inference_mode():
            y = torch.from_numpy(mono).to(dev)
            on_card = report._tempogram_graph(y, n_valid, sr=SR, hop_length=512)[:, :f_valid].cpu().numpy()
            tempogram_ms = time_cuda_ms(lambda: report._tempogram_graph(y, n_valid, sr=SR, hop_length=512), reps=5, warmup=1)
            on_host = report._tempogram_graph(torch.from_numpy(mono), n_valid, sr=SR, hop_length=512)[:, :f_valid].numpy()
        check(on_card.shape == (384, f_valid) and bool(np.isfinite(on_card).all()), f"tempogram {on_card.shape}")
        off = float(np.abs(on_card - on_host).max())
        check(off <= 1e-4, f"tempogram: card and host differ by {off}, beyond 1e-4")
        print(f"tempogram graph {on_card.shape}: card against host within {off:.2e}; {tempogram_ms:.2f} ms on the card -- {card}")
        del y

        # The one call a user makes, stems and artefacts together. The plots
        # need matplotlib: without it the call must get as far as the stems,
        # report.json and the CSVs and then raise ImportError, never skip them.
        have_plots = importlib.util.find_spec("matplotlib") is not None
        print(f"matplotlib: {'present' if have_plots else 'absent'}")
        path = Path(tmp) / "track_181s.wav"
        write_wav(path, main_track, SR)
        full = Path(tmp) / "full"
        stem_files = tuple(f"track_181s_{name}.wav" for name in stem_names)
        stages = []
        launches.reset()
        t0 = time.perf_counter()
        try:
            rendered = analyse_track(str(path), output_dir=full, use_stems=True, device="cuda", progress_callback=stages.append)
        except ImportError as exc:
            check(not have_plots, f"plots failed though matplotlib is installed: {exc}")
            rendered = None
            print(f"a request for plots without matplotlib raises ImportError: {exc}")
        else:
            check(have_plots, "plots were asked for without matplotlib and nothing was raised")
        torch.cuda.synchronize()
        full_ms = (time.perf_counter() - t0) * 1e3
        path_launches["analyse_track(output_dir, use_stems=True)"] = counts = launches.read()
        expected = {"median31_time": 2, "median31_freq": 2, "stft_magnitude": 0}
        check(counts == expected, f"analyse_track(output_dir, use_stems=True): launches {counts}, expected {expected}")
        check(stages[-1] == ("render" if have_plots else "stems"), f"progress stages {stages}")
        if have_plots:
            hold_artefacts(full, TABLE_FILES + PLOT_FILES + stem_files, rendered.beat.bpm)
            check(rendered.stems.model_name == "bandsplit-masknet-v5", f"stems {rendered.stems}")
        else:
            missing = [name for name in ("report.json", "beats.csv", "sections.csv") + stem_files if not (full / name).is_file()]
            check(not missing, f"before the plots failed the call should have written {missing}")
            check(not list(full.glob("*.png")), "a plot was written without matplotlib")
        for name in stem_files:
            written, _sr, _meta = decode_wav(full / name)
            check(written.shape == main_track.shape and bool(np.isfinite(written).all()), f"{name}: {written.shape}")
        print(
            f"analyse_track(path, output_dir, use_stems=True): {full_ms:.1f} ms wall, wrote {sorted(p.name for p in full.iterdir())}; "
            f"launches {json.dumps(counts)} -- {card}"
        )
    print(f"chip_smoke wall so far: {time.perf_counter() - wall_start:.1f} s")

    # ---- 11-13. per-module path, ms6 / ms5, CLI -------------------------------
    try:
        per_module_phase(card, launches, path_launches, main_track, excerpt)
        subbyte_phase(card, launches, path_launches, main_track, sources, lengths, good)
        cli_phase(card, main_track, main_result.beat.bpm, sources, good)
        decode_phase(card, cpu, launches, path_launches, main_track)
        sharded_timings = sharded_phase(card, path_launches, main_track, minmax_per_s)
        training_phase(card)
        independent_timings = independent_phase(card, launches, path_launches, minmax_per_s)
        api_surface_phase(card)
        mesh_phase(card, launches, path_launches, sources, lengths, good)
    finally:
        library_dir.cleanup()
    print(f"chip_smoke wall: {time.perf_counter() - wall_start:.1f} s")

    total = {k: sum(p[k] for p in path_launches.values()) for k in ("median31_time", "median31_freq", "stft_magnitude")}
    kernels = []
    for axis in (-1, -2):
        name, replaces = REPLACES[axis]
        timing = median_timings[(batch_shape, axis)]
        stems = stems_median[axis]
        kernels.append(
            {
                "name": name, "route": "cuda", "source": MEDIAN_SOURCE, "replaces": replaces,
                "launches": total[name],
                "max_abs_err": max([errs[axis]] + [sharded_timings[(w, axis)]["max_abs_err"] for w in (1, 2)]),
                **timing,  # ms, plain_ms, library_ms, both bounds, r and minmax_per_output
                "shape": list(batch_shape), "launches_by_path": {k: v[name] for k, v in path_launches.items()},
                "one_lane": median_timings[(MAIN_SHAPE, axis)],
                "stems_shape": list(STEMS_SHAPE), "stems_ms": stems["ms"], "stems_plain_ms": stems["plain_ms"],
                "stems_bound_ms": stems["bound_ms"], "stems_bound_by": stems["bound_by"],
                "sharded_per_rank": {f"world {w}": sharded_timings[(w, axis)] for w in (1, 2)},
                "independent_22050": {k: independent_timings[(k, axis)] for k in ("analysis", "separator")},
            }
        )
    kernel_ms, plain_ms, library_ms, bound_ms, bound_by = stft_timings[2 * SWEEP_BATCH]
    kernels.append(
        {
            "name": "stft_magnitude", "route": "cuda", "source": STFT_SOURCE, "replaces": STFT_REPLACES,
            "launches": total["stft_magnitude"], "max_abs_err": stft_abs_err, "max_frame_norm_err": stft_err,
            "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "shape": [2 * SWEEP_BATCH, BUCKET], "blocks_per_sm": stft_blocks_per_sm,
            "launches_by_path": {k: v["stft_magnitude"] for k, v in path_launches.items()},
            "independent_22050": independent_timings["stft"],
        }
    )
    print(json.dumps({"kernels": kernels}))
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
    try:
        main()
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr, flush=True)
        raise SystemExit(1)
