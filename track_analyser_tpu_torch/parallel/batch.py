"""Library sweep and single-track analysis through the batched fused graph.

Counterpart of the JAX package's ``parallel/batch.py``. Every dispatch
runs ``_core_graph`` on a batch of lanes: the fused graph
(``substrate.full_track_graph``, ``pack_outputs``) plus the downbeat TCN
when its checkpoint is bundled, for B tracks of one bucket length at
once (the reference's ``vmap`` over lanes, written out as a leading batch
axis).

- ``analyse_track_fused`` stages one track and dispatches it as a batch
  of one.
- ``analyse_library`` streams a library through a bounded pipeline:
  decode + quantise workers, upload workers (pinned host buffers, one
  side stream each), one batched dispatch per chunk of ``device_batch``
  lanes of one bucket, and finish workers that read back, unpack lane by
  lane, run the host finishers and (with ``output_dir``) render each
  track's artefacts.

Transports (host -> device payloads): "float32", "int16", "int8"
(blockwise int8 per channel), "ms" (the mid channel only, as blockwise
int8, with every side-derived output computed exactly on the host), and
"ms6" / "ms5" (the mid channel as packed 6- or 5-bit codes, per block raw
or delta-coded, in the reference's byte format). Staging quantises
through the native host library (``native/binding``, the JAX package's
C++ quantisers, which release the GIL); the numpy functions here
(``_quantise_i16``, ``_quantise_i8``, ``_quantise_mid_range``,
``_quantise_mid6_range``, ``_quantise_mid5_range``) are their plain
versions, which the tests hold the library against bit for bit, and
nothing on the main path calls them. The reference's relay machinery (chunked
parts, zero-chunk markers, device-side growth, executable sharing) is
not ported: the port uploads one buffer per payload part, the mid
payload covering the whole bucket.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from pathlib import Path
from typing import TYPE_CHECKING, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import harmony as harmony_mod
from .. import tempo as tempo_mod
from ..analysis import beats as beats_mod
from ..analysis import loudness as loudness_mod
from ..analysis import structure as structure_mod
from ..config import DEFAULT_CONFIG, DEFAULT_SEED
from ..device import check_nans, resolve_device
from ..features import FeatureAnalysis, FeatureSeries, LongTermAverageSpectrum
from ..models import downbeat as downbeat_model
from ..models import downbeat_net
from ..native import binding as native_binding
from ..ops import cuda_build, fused_stft
from ..ops.stft import fft_frequencies, hann_window
from ..pipeline import TrackAnalysisResult
from ..stereo import StereoAnalysis, StereoWidthBands
from ..substrate import bucket_length, full_track_graph, pack_outputs, unpack_outputs
from ..utils import AudioInput, coerce_audio, deterministic_rng

if TYPE_CHECKING:
    from ..report import ReportRequest

__all__ = [
    "analyse_track_fused",
    "analyse_library",
    "result_from_graph_outputs",
    "ms_bucket_length",
    "TrackFailure",
    "SkippedTrack",
    "upload_bytes",
    "reset_upload_bytes",
    "stage_seconds",
    "reset_stage_seconds",
]

_TRANSPORTS = ("float32", "int16", "int8", "ms", "ms6", "ms5")
# Bits per mid code of the mid-only transports.
_MS_BITS = {"ms": 8, "ms6": 6, "ms5": 5}


@dataclass(slots=True)
class TrackFailure:
    """Per-source failure record returned by :func:`analyse_library`: the
    track could not be decoded or staged. The sweep goes on, and the
    caller sees the failure in the track's position."""

    source: str
    error: str


@dataclass(slots=True)
class SkippedTrack:
    """A source this process did not analyse: the manifest of an earlier
    sweep lists it as done (``reason="manifest"``), or ``shard`` gave it
    to another process (``reason="other-shard"``)."""

    source: str
    reason: str = "manifest"


# Process-wide host -> device byte counter: the payload bytes each upload
# hands to the card (n_valid included).
_UPLOAD_BYTES = [0]
# Process-wide seconds per sweep stage, summed over tracks or chunks
# (see analyse_library); instrumentation read by chip_smoke.py.
_STAGE_SECONDS: Dict[str, float] = {}
_counters_lock = threading.Lock()


def _count_upload(nbytes: int) -> None:
    with _counters_lock:
        _UPLOAD_BYTES[0] += int(nbytes)


def reset_upload_bytes() -> None:
    with _counters_lock:
        _UPLOAD_BYTES[0] = 0


def upload_bytes() -> int:
    with _counters_lock:
        return _UPLOAD_BYTES[0]


def _count_stage(name: str, seconds: float) -> None:
    with _counters_lock:
        _STAGE_SECONDS[name] = _STAGE_SECONDS.get(name, 0.0) + seconds


def reset_stage_seconds() -> None:
    with _counters_lock:
        _STAGE_SECONDS.clear()


def stage_seconds() -> Dict[str, float]:
    """Seconds per stage since the last reset: "decode" (coerce_audio),
    "quantise" (host staging), "upload" (host time to stage and enqueue
    the copies), "dispatch" (host time to enqueue a chunk's graph),
    "graph" (the graph on the device, CUDA events; absent on the CPU),
    "finish" (readback, unpack and host finishers)."""

    with _counters_lock:
        return dict(_STAGE_SECONDS)


def _rms_hop(sr: int, seconds: float) -> int:
    fl = max(1024, int(round(sr * seconds)))
    if fl % 2:
        fl += 1
    return max(1, fl // 2)


def result_from_graph_outputs(
    audio: AudioInput,
    out: Dict[str, np.ndarray],
    *,
    seed: int = DEFAULT_SEED,
) -> TrackAnalysisResult:
    """Assemble a TrackAnalysisResult from fused-graph outputs (host)."""

    sr = audio.sample_rate
    n = len(audio.samples)
    hop = DEFAULT_CONFIG.hop_length
    f_valid = 1 + n // hop
    duration = n / float(sr)
    rng = deterministic_rng(seed)

    env = np.asarray(out["onset_env"], dtype=np.float64)[:f_valid]

    # --- beats (ac=None -> float64 host autocorrelation) -----------------
    grid, bpm = tempo_mod.grid_and_bpm_from_env(env, None, duration, sr, hop_length=hop)
    tracked_times = tempo_mod.track_beats(
        env,
        sr,
        hop_length=hop,
        bpm=bpm,
        low_energy=np.asarray(out["low_energy"], dtype=np.float64)[:f_valid],
    )
    beat_result = beats_mod.build_beat_analysis(
        bpm, grid["time"], sr, hop_length=hop, grid=grid, tracked_times=tracked_times,
    )

    # --- downbeats (accent + optional net evidence) -----------------------
    net_prob = out.get("net_prob")
    if net_prob is not None:
        net_prob = np.asarray(net_prob, dtype=np.float64)[:f_valid]
    # Drift-following tracked beats are the downbeat time base when the
    # tracker produced a sane sequence; the constant grid otherwise.
    db_base = (
        tracked_times
        if tracked_times is not None and len(tracked_times) >= 8
        else np.asarray(beat_result.beat_times, dtype=float)
    )
    tracked = downbeat_model.decode_from_accent(
        np.asarray(out["beat_energy"], dtype=np.float64)[:f_valid],
        np.asarray(out["low_energy"], dtype=np.float64)[:f_valid],
        np.asarray(db_base, dtype=float),
        sr,
        flux=env,
        net_prob=net_prob,
        chroma=np.asarray(out["chroma_cq"], dtype=np.float64)[:, :f_valid],
    )
    if tracked is not None and tracked.downbeat_times:
        downbeat_result = beats_mod.DownbeatAnalysis(
            downbeat_times=tracked.downbeat_times,
            beat_positions=tracked.beat_positions,
            source=tracked.source,
        )
    else:
        downbeat_result = beats_mod._fallback_downbeats(beat_result)

    # --- structure --------------------------------------------------------
    structure_result = structure_mod.segments_from_curves(
        np.asarray(out["novelty"], dtype=np.float64)[:f_valid],
        np.asarray(out["energy_novelty"], dtype=np.float64)[:f_valid],
        np.asarray(out["perc_col"], dtype=np.float64)[:f_valid],
        np.asarray(out["harm_col"], dtype=np.float64)[:f_valid],
        beat_result,
        sample_rate=sr,
        hop_length=hop,
        duration=duration,
    )

    # --- loudness ---------------------------------------------------------
    st_n = 1 + n // _rms_hop(sr, DEFAULT_CONFIG.short_term_seconds)
    mo_n = 1 + n // _rms_hop(sr, DEFAULT_CONFIG.loudness_block_seconds)
    short_term = np.asarray(out["short_term_db"], dtype=float)[:st_n]
    momentary = np.asarray(out["momentary_db"], dtype=float)[:mo_n]
    lra = float(np.percentile(momentary, 95) - np.percentile(momentary, 5))
    loudness_result = loudness_mod.LoudnessAnalysis(
        integrated_lufs=float(out["integrated_lufs"]),
        short_term_lufs=short_term.tolist(),
        momentary_lufs=momentary.tolist(),
        loudness_range=lra,
        true_peak_dbfs=float(20.0 * np.log10(float(out["true_peak"]) + 1e-12)),
        rms_dbfs=float(20.0 * np.log10(float(out["rms"]) + 1e-12)),
    )

    # --- harmony ----------------------------------------------------------
    keys = [f"{p} major" for p in harmony_mod.PITCH_CLASS_NAMES]
    keys += [f"{p} minor" for p in harmony_mod.PITCH_CLASS_NAMES]
    key_result = harmony_mod._keys_from_scores(
        np.asarray(out["key_scores"], dtype=np.float64), keys
    )
    chroma_cq = np.asarray(out["chroma_cq"], dtype=np.float64)[:, :f_valid]
    chord_hints = harmony_mod._estimate_chords(chroma_cq, beat_result, rng)
    change_points = harmony_mod._detect_chord_changes(chroma_cq, beat_result, chord_hints)

    total = float(out["balance_total"])
    if total > 0:
        balance = harmony_mod.SpectralBalance(
            low_band=float(out["balance_low"]) / total,
            mid_band=float(out["balance_mid"]) / total,
            high_band=float(out["balance_high"]) / total,
        )
    else:
        balance = harmony_mod.SpectralBalance(0.0, 0.0, 0.0)

    if audio.stereo_samples is None:
        stereo_image = harmony_mod.StereoImage(correlation=1.0, balance=0.0)
    else:
        stereo_image = harmony_mod.StereoImage(
            correlation=float(out["stereo_corr_centered"]),
            balance=float(out["stereo_balance"]),
        )

    start_offset = (
        downbeat_result.downbeat_times[0]
        if downbeat_result and downbeat_result.downbeat_times
        else (beat_result.beat_times[0] if beat_result.beat_times else 0.0)
    )
    hook = harmony_mod._generate_midi(
        chroma_cq, beat_result, key_result.best, rng, name="hook", start_offset=start_offset
    )
    bass = harmony_mod._generate_midi(
        chroma_cq,
        beat_result,
        key_result.best,
        rng,
        name="bass",
        octave=-1,
        start_offset=start_offset,
    )
    harmonic_result = harmony_mod.HarmonyAnalysis(
        spectral_balance=balance,
        stereo_image=stereo_image,
        primary_key=key_result.best,
        secondary_key=key_result.second_best,
        chord_hints=chord_hints,
        chord_change_points=change_points,
        hook_suggestion=hook,
        bass_suggestion=bass,
    )

    # --- features ---------------------------------------------------------
    features_result = FeatureAnalysis(
        ltas=LongTermAverageSpectrum(
            frequencies=fft_frequencies(sr, DEFAULT_CONFIG.n_fft),
            magnitude=np.asarray(out["ltas"], dtype=np.float64)[
                : 1 + DEFAULT_CONFIG.n_fft // 2
            ],
        ),
        spectral_centroid=FeatureSeries(
            values=np.asarray(out["centroid"], dtype=np.float64)[:f_valid]
        ),
        spectral_rolloff=FeatureSeries(
            values=np.asarray(out["rolloff"], dtype=np.float64)[:f_valid]
        ),
    )

    # --- stereo -----------------------------------------------------------
    widths = np.asarray(out["stereo_widths"], dtype=np.float64)
    stereo_result = StereoAnalysis(
        mid_rms=float(out["mid_rms"]),
        side_rms=float(out["side_rms"]),
        correlation=float(out["stereo_corr_centered"]),
        width=StereoWidthBands(
            low=float(widths[0]), mid=float(widths[1]), high=float(widths[2])
        ),
    )

    return TrackAnalysisResult(
        audio=audio,
        beat=beat_result,
        downbeat=downbeat_result,
        structure=structure_result,
        loudness=loudness_result,
        harmonic=harmonic_result,
        features=features_result,
        stereo=stereo_result,
    )


def _pad_track(audio: AudioInput, n_bucket: int) -> tuple[np.ndarray, int]:
    """Channel-major (2, n_bucket) float32 payload and n_valid; mono
    tracks duplicate their channel (the downmix then reproduces the mono
    signal exactly)."""

    n = len(audio.samples)
    stereo = np.zeros((2, n_bucket), dtype=np.float32)
    if audio.stereo_samples is not None and audio.stereo_samples.ndim == 2:
        stereo[:, :n] = audio.stereo_samples[:2, :n]
    else:
        stereo[0, :n] = audio.samples
        stereo[1, :n] = audio.samples
    return stereo, n


def _quantise_i16(x: np.ndarray) -> np.ndarray:
    """Truncating float32 -> int16 at full scale 32768 (-96 dBFS
    quantisation), the JAX package's int16 payload bit for bit."""

    buf = np.multiply(x, np.float32(32768.0), dtype=np.float32)
    np.clip(buf, np.float32(-32768.0), np.float32(32767.0), out=buf)
    return buf.astype(np.int16)


# ---------------------------------------------------------------------------
# Blockwise int8 transports ("int8", "ms"): numpy copies of the reference's
# quantisers, bit for bit.
# ---------------------------------------------------------------------------

# Samples per int8 scaling block; equals the bucket quantum (hop*128), so
# every bucket length divides evenly. Coarse on purpose (~1.5 s at 44.1
# kHz): short blocks step the quantisation noise floor at every block
# boundary, and the onset detector reads the steps as micro-onsets.
_I8_BLOCK = 65_536

# The "ms" tier grid: tracks longer than _MS_TIER_MIN_SAMPLES pad to a
# whole number of _MS_CHUNK_SAMPLES chunks from _MS_TIERS, and the
# quantiser covers the bucket only through the _MS_TAIL_GRANULE holding
# the last valid sample (the rest is zeros, which decode to silence). The
# port keeps the reference's bucket lengths because the results depend
# on them near a track's end (ROADMAP Queue 3).
_MS_CHUNKS = 4
_MS_CHUNK_SAMPLES = 1 << 21
_MS_TIER_MIN_SAMPLES = 1 << 21
_MS_TIERS = (4, 6, 8, 12, 16, 24, 32)
_MS_TAIL_GRANULE = 1 << 18


def _source_channels(audio: AudioInput) -> np.ndarray:
    """(2, n) or (n,) float32 view of the raw signal for the quantisers."""

    if audio.stereo_samples is not None and audio.stereo_samples.ndim == 2:
        return np.asarray(audio.stereo_samples[:2], dtype=np.float32)
    return np.asarray(audio.samples, dtype=np.float32)


def _quantise_i8(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Blockwise-scaled int8 of (C, n): (values (C, n) int8, scales
    (C, n / _I8_BLOCK) float32), rounded to nearest (truncation's bias
    would shrink the signal energy by 0.1-0.3 dB)."""

    c, n = x.shape
    blocks = x.reshape(c, n // _I8_BLOCK, _I8_BLOCK)
    scales = np.abs(blocks).max(axis=-1).astype(np.float32)
    inv = np.float32(127.0) / np.where(scales > 0, scales, np.float32(1.0))
    buf = np.multiply(blocks, inv[:, :, None], dtype=np.float32)
    np.clip(buf, np.float32(-127.0), np.float32(127.0), out=buf)
    np.rint(buf, out=buf)
    return buf.astype(np.int8).reshape(c, n), scales


def _dequantise_i8(vals: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Inverse of ``_quantise_i8`` on (..., n) values and (..., n/_I8_BLOCK)
    scales."""

    blocks = vals.to(torch.float32).reshape(vals.shape[:-1] + (-1, _I8_BLOCK))
    return (blocks * (scales[..., None] / 127.0)).reshape(vals.shape)


def _unpack_codes(packed: torch.Tensor, bits: int) -> torch.Tensor:
    """(..., n) int32 codes, bias removed, from (..., n * bits / 8) packed
    bytes: 6-bit codes four in three bytes, 5-bit codes eight in five."""

    if bits == 6:
        b = packed.reshape(packed.shape[:-1] + (-1, 3)).to(torch.int32)
        codes = [
            b[..., 0] >> 2,
            ((b[..., 0] & 3) << 4) | (b[..., 1] >> 4),
            ((b[..., 1] & 15) << 2) | (b[..., 2] >> 6),
            b[..., 2] & 63,
        ]
        bias = 32
    else:
        b = packed.reshape(packed.shape[:-1] + (-1, 5)).to(torch.int32)
        codes = [
            b[..., 0] >> 3,
            ((b[..., 0] & 7) << 2) | (b[..., 1] >> 6),
            (b[..., 1] >> 1) & 31,
            ((b[..., 1] & 1) << 4) | (b[..., 2] >> 4),
            ((b[..., 2] & 15) << 1) | (b[..., 3] >> 7),
            (b[..., 3] >> 2) & 31,
            ((b[..., 3] & 3) << 3) | (b[..., 4] >> 5),
            b[..., 4] & 31,
        ]
        bias = 16
    stacked = torch.stack(codes, dim=-1)
    return stacked.reshape(packed.shape[:-1] + (-1,)) - bias


def _dequantise_subbyte(
    packed: torch.Tensor, scales: torch.Tensor, bases: torch.Tensor, bits: int
) -> torch.Tensor:
    """Inverse of the ms6 / ms5 quantiser on (..., bytes) packed codes and
    (..., blocks) scales and bases: per block, the scale's sign picks raw
    (code * step) or delta (base + int32-cumsum(codes) * step), step =
    |scale| / qmax. The multiply and the add are two operations, never a
    fused multiply-add."""

    qmax = 31.0 if bits == 6 else 15.0
    codes = _unpack_codes(packed, bits)
    cb = codes.reshape(codes.shape[:-1] + (scales.shape[-1], -1))
    step = (torch.abs(scales) / qmax)[..., None]
    raw = cb.to(torch.float32) * step
    delta = bases[..., None] + torch.cumsum(cb, dim=-1, dtype=torch.int32).to(torch.float32) * step
    return torch.where((scales < 0)[..., None], delta, raw).reshape(codes.shape)


def _stage_payload_i16(audio: AudioInput, n_bucket: int) -> tuple[tuple, int]:
    """((2, n_bucket) int16,) payload + n_valid: the native pad + quantise,
    ``_quantise_i16`` of ``_pad_track`` bit for bit."""

    payload = native_binding.quantise_i16_stereo(_source_channels(audio), n_bucket)
    return (payload,), len(audio.samples)


def _stage_payload_i8(audio: AudioInput, n_bucket: int) -> tuple[tuple, int]:
    """(values (2, n_bucket) int8, scales (2, n_bucket/_I8_BLOCK)) + n_valid:
    the native pad + quantise, ``_quantise_i8`` of ``_pad_track`` bit for bit."""

    return native_binding.quantise_i8(_source_channels(audio), n_bucket, _I8_BLOCK), len(audio.samples)


def ms_bucket_length(n: int) -> int:
    """Pad target of the "ms" transport: geometric buckets up to
    _MS_TIER_MIN_SAMPLES samples, the tier grid beyond (past the tier
    table, multiples of 8 chunks)."""

    if n <= _MS_TIER_MIN_SAMPLES:
        return bucket_length(n)
    chunks = -(-n // _MS_CHUNK_SAMPLES)
    for t in _MS_TIERS:
        if chunks <= t:
            return t * _MS_CHUNK_SAMPLES
    return -(-chunks // 8) * 8 * _MS_CHUNK_SAMPLES


def _ms_chunk_ranges(n_bucket: int) -> "list[tuple[int, int]]":
    """Block-aligned [start, end) chunk ranges covering ``n_bucket`` (the
    reference's upload chunks; here they only set how far the quantiser
    covers a geometric bucket)."""

    if n_bucket > _MS_TIER_MIN_SAMPLES and n_bucket % _MS_CHUNK_SAMPLES == 0:
        return [(s, s + _MS_CHUNK_SAMPLES) for s in range(0, n_bucket, _MS_CHUNK_SAMPLES)]
    nb = n_bucket // _I8_BLOCK
    c = max(1, min(_MS_CHUNKS, nb))
    base, rem = divmod(nb, c)
    ranges = []
    pos = 0
    for i in range(c):
        size = (base + (1 if i < rem else 0)) * _I8_BLOCK
        ranges.append((pos, pos + size))
        pos += size
    return ranges


def _ms_quantise_len(n: int, n_bucket: int) -> int:
    """How far the quantiser covers the bucket: on the tier grid through
    the granule holding the last valid sample, on geometric buckets
    through the chunk holding it."""

    if n_bucket > _MS_TIER_MIN_SAMPLES and n_bucket % _MS_CHUNK_SAMPLES == 0:
        return min(-(-n // _MS_TAIL_GRANULE) * _MS_TAIL_GRANULE, n_bucket)
    return next((e for _s, e in _ms_chunk_ranges(n_bucket) if e >= n), n_bucket)


def _stereo_stats(l: np.ndarray, r: np.ndarray, n_valid: int) -> np.ndarray:
    """[n, sum_l, sum_r, sum_ll, sum_rr, sum_lr, sum_abs_l, sum_abs_r] in
    float64 over the valid samples."""

    lv = l[:n_valid].astype(np.float64, copy=False)
    rv = r[:n_valid].astype(np.float64, copy=False)
    return np.array(
        [
            float(n_valid),
            float(lv.sum()),
            float(rv.sum()),
            float(np.dot(lv, lv)),
            float(np.dot(rv, rv)),
            float(np.dot(lv, rv)),
            float(np.abs(lv).sum()),
            float(np.abs(rv).sum()),
        ]
    )


def _host_stereo_widths(
    channels: np.ndarray,
    sr: int,
    *,
    n_fft: int = 2048,
    hop: int = 512,
    max_frames: int = 192,
) -> np.ndarray:
    """Per-band stereo widths sqrt(E_side / E_mid) on the host in float64:
    the device graph's band-energy estimator (Hann n_fft/hop STFT, means
    over the 0-200 / 200-2000 / 2000-Nyquist Hz bands) over an evenly
    strided subset of at most ``max_frames`` centred frames, so the "ms"
    transport need not ship the side channel."""

    l = channels[0]
    r = channels[-1]
    n = l.shape[-1]
    if n == 0:
        return np.zeros(3)
    total = 1 + n // hop
    stride = -(-total // max_frames)
    starts = np.arange(0, total, stride) * hop - n_fft // 2
    # Gather only the sampled frames; clipped indices and a validity mask
    # reproduce the zero padding exactly.
    idx = starts[:, None] + np.arange(n_fft)[None, :]
    valid = ((idx >= 0) & (idx < n)).astype(np.float64)
    idx_c = np.clip(idx, 0, n - 1)
    win = hann_window(n_fft).astype(np.float64) * valid
    fl = l[idx_c].astype(np.float64) * win
    fr = r[idx_c].astype(np.float64) * win
    mid_e = np.abs(np.fft.rfft(0.5 * (fl + fr), axis=-1)) ** 2
    side_e = np.abs(np.fft.rfft(0.5 * (fl - fr), axis=-1)) ** 2

    freqs = np.linspace(0.0, sr / 2.0, 1 + n_fft // 2)
    nyq = sr / 2.0
    widths = np.zeros(3)
    for k, (lo_f, hi_f) in enumerate(
        ((0.0, min(200.0, nyq)), (200.0, min(2000.0, nyq)), (2000.0, nyq))
    ):
        band = (freqs >= lo_f) & (freqs <= hi_f)
        m = float(np.mean(mid_e[:, band])) if band.any() else 0.0
        s = float(np.mean(side_e[:, band])) if band.any() else 0.0
        widths[k] = 0.0 if m <= 1e-12 else float(np.sqrt(s / m))
    return widths


def _quantise_mid_range(
    channels: np.ndarray, n_in: int, start: int, end: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Mid quantise + exact stereo sums for source samples [start, end)
    (block-aligned): (mid int8 (L,), mid scales (L/_I8_BLOCK,), stats (8,)
    float64). Samples past ``n_in`` are zeros."""

    blocklen = end - start
    valid = int(max(0, min(n_in - start, blocklen)))
    l = channels[0, start : start + valid]
    r = channels[-1, start : start + valid]
    stats = _stereo_stats(l, r, valid)

    mid = np.zeros(blocklen, dtype=np.float32)
    np.multiply(np.add(l, r, dtype=np.float32), np.float32(0.5), out=mid[:valid])
    mid_i8, mid_scales = _quantise_i8(mid[None, :])
    return mid_i8[0], mid_scales[0], stats


def _pack_i6(codes: np.ndarray) -> np.ndarray:
    """Pack biased 6-bit codes (uint8 in [1, 63]) four into three bytes,
    the reference's byte format (``_dequantise_mono_i6`` unpacks it)."""

    g = codes.reshape(-1, 4)
    out = np.empty((g.shape[0], 3), dtype=np.uint8)
    out[:, 0] = (g[:, 0] << 2) | (g[:, 1] >> 4)
    out[:, 1] = ((g[:, 1] & 15) << 4) | (g[:, 2] >> 2)
    out[:, 2] = ((g[:, 2] & 3) << 6) | g[:, 3]
    return out.reshape(-1)


def _pack_i5(codes: np.ndarray) -> np.ndarray:
    """Pack biased 5-bit codes (uint8 in [1, 31]) eight into five bytes,
    the reference's byte format (``_dequantise_mono_i5`` unpacks it)."""

    g = codes.reshape(-1, 8).astype(np.uint16)
    out = np.empty((g.shape[0], 5), dtype=np.uint8)
    out[:, 0] = (g[:, 0] << 3) | (g[:, 1] >> 2)
    out[:, 1] = ((g[:, 1] & 3) << 6) | (g[:, 2] << 1) | (g[:, 3] >> 4)
    out[:, 2] = ((g[:, 3] & 15) << 4) | (g[:, 4] >> 1)
    out[:, 3] = ((g[:, 4] & 1) << 7) | (g[:, 5] << 2) | (g[:, 6] >> 3)
    out[:, 4] = ((g[:, 6] & 7) << 5) | g[:, 7]
    return out.reshape(-1)


def _quantise_mid_subbyte_range(
    channels: np.ndarray,
    n_in: int,
    start: int,
    end: int,
    carry: float,
    *,
    qmax: int,
    block: int,
    bias: int,
    shape: float = 0.0,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, float]:
    """The sub-byte mid quantiser (ms6 / ms5) for source samples
    [start, end), the reference's numpy quantiser op for op in float32.

    Per block, the better of two codings in [-qmax, qmax]: raw (code =
    x / step, step = peak / qmax) and delta with error feedback (each
    code steps the running reconstruction towards the next sample, step
    = max |first difference| / qmax); delta wins when its worst error is
    under half the raw one. The mode rides the scale's sign (negative:
    delta). ``bases`` holds the true padded-mid sample before each block
    (``carry`` before the first), so blocks decode independently and the
    delta chains of all blocks advance in lock-step, one sample per
    iteration. ``shape`` > 0 noise-shapes the delta target (x[i] -
    shape * e[i-1]). Returns (biased codes (L,) uint8, scales (L/block,),
    bases (L/block,), stats (8,) float64, carry out); an empty range
    gives empty parts (the reference raises IndexError there)."""

    blocklen = end - start
    valid = int(max(0, min(n_in - start, blocklen)))
    l = channels[0, start : start + valid]
    r = channels[-1, start : start + valid]
    stats = _stereo_stats(l, r, valid)

    mid = np.zeros(blocklen, dtype=np.float32)
    np.multiply(np.add(l, r, dtype=np.float32), np.float32(0.5), out=mid[:valid])
    blocks = mid.reshape(-1, block)
    nb = blocks.shape[0]
    if nb == 0:
        empty = np.zeros(0, dtype=np.float32)
        return np.zeros(0, dtype=np.uint8), empty, empty.copy(), stats, float(carry)
    fq = np.float32(float(qmax))

    prevs = np.empty(nb, np.float32)
    prevs[0] = np.float32(carry)
    if nb > 1:
        prevs[1:] = blocks[:-1, -1]

    peak = np.abs(blocks).max(axis=1).astype(np.float32)
    # max |first difference| over the padded row with the base prepended
    dpk = (
        np.abs(np.diff(blocks, axis=1, prepend=prevs[:, None].astype(np.float32)))
        .max(axis=1)
        .astype(np.float32)
    )

    # raw candidate
    peak_safe = np.where(peak > 0, peak, np.float32(1.0))
    rstep = peak_safe / fq
    rinv = fq / peak_safe
    rcodes = np.rint(np.clip(blocks * rinv[:, None], -fq, fq)).astype(np.float32)
    rerr = np.abs(rcodes * rstep[:, None] - blocks).max(axis=1).astype(np.float32)

    # delta candidate: every block's error-feedback chain in lock-step
    run = dpk > 0
    dpk_safe = np.where(run, dpk, np.float32(1.0))
    dstep = dpk_safe / fq
    dinv = fq / dpk_safe
    fshape = np.float32(shape)
    dcodes = np.empty((nb, block), np.float32)
    acc = np.zeros(nb, np.int32)
    prev = prevs.copy()
    e_prev = np.zeros(nb, np.float32)
    derr = np.zeros(nb, np.float32)
    for i in range(block):
        x = blocks[:, i]
        tgt = x - fshape * e_prev
        v = (tgt - prev) * dinv
        c = np.rint(np.clip(v, -fq, fq))
        dcodes[:, i] = c
        acc += c.astype(np.int32)
        prev = prevs + acc.astype(np.float32) * dstep
        e_prev = prev - x
        np.maximum(derr, np.abs(e_prev), out=derr)
    take_delta = run & (derr < np.float32(0.5) * rerr)

    bases = prevs
    scales = np.where(take_delta, -dpk, peak).astype(np.float32)
    sel = np.where(take_delta[:, None], dcodes, rcodes)
    codes_all = (sel + np.float32(float(bias))).astype(np.uint8)
    carry_out = float(blocks[-1, -1])
    return codes_all.reshape(-1), scales, bases, stats, carry_out


def _quantise_mid6_range(
    channels: np.ndarray, n_in: int, start: int, end: int, carry: float = 0.0
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, float]:
    """ms6: 6-bit codes on the _I8_BLOCK scale grid, packed four into
    three bytes (0.75 B per stereo sample pair)."""

    codes, scales, bases, stats, carry_out = _quantise_mid_subbyte_range(
        channels, n_in, start, end, carry, qmax=31, block=_I8_BLOCK, bias=32
    )
    return _pack_i6(codes), scales, bases, stats, carry_out


def _quantise_mid5_range(
    channels: np.ndarray, n_in: int, start: int, end: int, carry: float = 0.0
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, float]:
    """ms5: noise-shaped 5-bit codes on the finer _MS5_BLOCK scale grid,
    packed eight into five bytes (0.625 B per stereo sample pair)."""

    codes, scales, bases, stats, carry_out = _quantise_mid_subbyte_range(
        channels, n_in, start, end, carry,
        qmax=15, block=_MS5_BLOCK, bias=16, shape=0.5,
    )
    return _pack_i5(codes), scales, bases, stats, carry_out


# ms5 quantises on a finer scale grid than _I8_BLOCK: at 5 bits a quiet
# click under a loud block peak's step, and noise-floor steps at a slow
# block rate aliasing into the tempo range, both move the beat grid at
# coarser blocks (the reference's measurements). 8 B of scale and base
# per 1 024 samples.
_MS5_BLOCK = 1024


def _ms_block(bits: int) -> int:
    return _MS5_BLOCK if bits == 5 else _I8_BLOCK


def _ms_payload_bytes(s: int, e: int, bits: int) -> "tuple[int, int]":
    """Byte range of the packed payload covering sample range [s, e)."""

    if bits == 6:
        return 3 * s // 4, 3 * e // 4
    if bits == 5:
        return 5 * s // 8, 5 * e // 8
    return s, e


def _stage_payload_ms(audio: AudioInput, n_bucket: int, bits: int = 8) -> tuple[tuple, tuple, int]:
    """(payload parts, (stats (8,), widths (3,) or None), n_valid) for
    the mid-only transports: "ms" (``bits=8``: int8 values (n_bucket,),
    scales (n_bucket/_I8_BLOCK,)), "ms6" and "ms5" (``bits=6`` / ``5``:
    packed codes (3/4 or 5/8 of n_bucket bytes), scales and bases, one
    each per block of ``_ms_block(bits)``).

    The native quantiser (carry 0) covers ``_ms_quantise_len`` samples;
    the rest of the bucket is zero bytes with zero scales and bases, which
    decode to silence (the reference ships those as zero chunks).
    ``widths`` is None for a mono source, whose device widths are exact."""

    n = len(audio.samples)
    channels = _source_channels(audio)
    if channels.ndim == 1:
        channels = channels[None, :]
    qlen = _ms_quantise_len(n, n_bucket)
    if bits == 8:
        vals_q, scales_q, stats = native_binding.quantise_mid(channels, qlen, _I8_BLOCK)
        bases_q = None
    else:
        quantise = native_binding.quantise_mid6 if bits == 6 else native_binding.quantise_mid5
        vals_q, scales_q, bases_q, stats, _carry = quantise(channels, qlen, _ms_block(bits))
    vals = np.zeros(_ms_payload_bytes(0, n_bucket, bits)[1], dtype=vals_q.dtype)
    vals[: vals_q.shape[0]] = vals_q
    n_blocks = n_bucket // _ms_block(bits)
    parts = [vals]
    for q in (scales_q, bases_q):
        if q is not None:
            full = np.zeros(n_blocks, dtype=np.float32)
            full[: q.shape[0]] = q
            parts.append(full)
    widths = None
    if audio.stereo_samples is not None:
        widths = _host_stereo_widths(channels, audio.sample_rate)
    return tuple(parts), (stats, widths), n


def _apply_host_stereo_stats(
    out: Dict[str, np.ndarray],
    stats: np.ndarray,
    widths: "np.ndarray | None" = None,
) -> None:
    """Overwrite the four time-domain stereo scalars (and, for stereo
    sources, the three per-band widths) with the host-exact values
    carried beside the mid-only payload."""

    if widths is not None:
        out["stereo_widths"] = np.asarray(widths, dtype=np.float64)
    n, sl, sr_, sll, srr, slr, sal, sar = [float(v) for v in stats]
    n = max(n, 1.0)
    lc2 = max(sll - sl * sl / n, 0.0)
    rc2 = max(srr - sr_ * sr_ / n, 0.0)
    dot = slr - sl * sr_ / n
    denom = np.sqrt(lc2) * np.sqrt(rc2)
    corr = 1.0 if denom <= 1e-12 else float(np.clip(dot / denom, -1.0, 1.0))
    out["stereo_corr_centered"] = np.float64(corr)
    out["stereo_balance"] = np.float64(sal / n - sar / n)
    out["mid_rms"] = np.float64(np.sqrt(max(sll + 2 * slr + srr, 0.0) / (4.0 * n)))
    out["side_rms"] = np.float64(np.sqrt(max(sll - 2 * slr + srr, 0.0) / (4.0 * n)))


def _check_transport(transport: str) -> None:
    if transport not in _TRANSPORTS:
        raise ValueError(f"unknown transport {transport!r}")


def _bucket_for(transport: str) -> Callable[[int], int]:
    """The reference's bucket for each transport: the tier grid for the
    mid-only transports, geometric buckets otherwise."""

    return ms_bucket_length if transport in _MS_BITS else bucket_length


def _stage_track(audio: AudioInput, transport: str, n_bucket: int) -> tuple[tuple, "tuple | None", int]:
    """(payload parts, host-exact stereo values or None, n_valid) of one
    track for ``transport``."""

    if transport in _MS_BITS:
        return _stage_payload_ms(audio, n_bucket, _MS_BITS[transport])
    if transport == "int8":
        parts, n_valid = _stage_payload_i8(audio, n_bucket)
    elif transport == "int16":
        parts, n_valid = _stage_payload_i16(audio, n_bucket)
    else:
        stereo, n_valid = _pad_track(audio, n_bucket)
        parts = (stereo,)
    return parts, None, n_valid


# ---------------------------------------------------------------------------
# The batched graph and its device plumbing.
# ---------------------------------------------------------------------------

def _bundled_net(device: torch.device) -> "torch.nn.Module | None":
    """The bundled downbeat net on ``device``, or None when disabled.

    On by default when the bundled checkpoint is a TCN; a GRU checkpoint
    is left out (its serial scan is too slow for the fused path; it
    serves the per-module path) unless TRACK_ANALYSER_TPU_NET_DOWNBEATS=1
    forces it in. TRACK_ANALYSER_TPU_NET_DOWNBEATS=0 disables."""

    gate = os.environ.get("TRACK_ANALYSER_TPU_NET_DOWNBEATS")
    if gate == "0":
        return None
    params = downbeat_model._net_params()
    if params is None or ("tcn0_w" not in params and gate != "1"):
        return None
    return downbeat_net.model_for(params, device)


def _core_graph(stereo: torch.Tensor, n_valid: torch.Tensor, *, sr: int) -> tuple:
    """Fused graph + packed outputs (+ the TCN's per-frame P(downbeat)
    when the bundled checkpoint exists) for a batch: stereo (B, 2, n),
    n_valid (B,). Every output has a leading batch axis."""

    out = full_track_graph(stereo, n_valid, sr=sr)
    net = _bundled_net(stereo.device)
    if net is None:
        check_nans("parallel.batch._core_graph", out)
        return pack_outputs(out)
    prob = downbeat_net.activation_graph(net, stereo.mean(dim=1), n_valid, sr=sr)
    check_nans("parallel.batch._core_graph", {**out, "net_prob": prob})
    return pack_outputs(out) + (prob,)


def _decode_payload(transport: str, parts: tuple) -> torch.Tensor:
    """Device-side decode of a batch's payload parts to (B, 2, n) float32.
    The mid-only transports feed [y, y]: the side outputs they cannot see
    come from the host."""

    if transport == "float32":
        return parts[0]
    if transport == "int16":
        return parts[0].to(torch.float32) / 32768.0
    if transport == "int8":
        return _dequantise_i8(parts[0], parts[1])
    if transport == "ms":
        y = _dequantise_i8(parts[0], parts[1])  # the mid channel, (B, n)
    else:
        y = _dequantise_subbyte(parts[0], parts[1], parts[2], _MS_BITS[transport])
    return torch.stack([y, y], dim=1)


_upload_local = threading.local()


def _upload(parts: "Sequence[np.ndarray]", n_valid: "Sequence[int]", dev: torch.device) -> tuple:
    """Host -> device copy of one batch's stacked payload parts and its
    n_valid. Returns (parts, n_valid, ready event or None).

    On CUDA each part is staged in pinned host memory and copied with
    ``non_blocking=True`` on this thread's own side stream (a copy from
    pageable memory would be synchronous); the dispatch waits on
    ``ready`` before the graph reads the parts."""

    arrays = [np.ascontiguousarray(p) for p in parts] + [np.asarray(n_valid, dtype=np.int64)]
    _count_upload(sum(a.nbytes for a in arrays))
    if dev.type != "cuda":
        tensors = [torch.from_numpy(a) for a in arrays]
        return tuple(tensors[:-1]), tensors[-1], None
    streams = _upload_local.__dict__.setdefault("streams", {})
    stream = streams.get(str(dev))
    if stream is None:
        stream = streams[str(dev)] = torch.cuda.Stream(device=dev)
    with torch.cuda.stream(stream):
        tensors = [torch.from_numpy(a).pin_memory().to(dev, non_blocking=True) for a in arrays]
        ready = torch.cuda.Event()
        ready.record(stream)
    return tuple(tensors[:-1]), tensors[-1], ready


def _dispatch(transport: str, staged: tuple, *, sr: int) -> tuple:
    """Enqueue the batched graph on the uploaded payload and, on CUDA, the
    readback of its outputs into pinned host buffers right behind it.
    Returns (host outputs, (start, graph done, copied) CUDA events or
    None); the host outputs are valid once ``copied`` has fired."""

    parts, n_valid, ready = staged
    if ready is None:
        with torch.inference_mode():
            return _core_graph(_decode_payload(transport, parts), n_valid, sr=sr), None
    stream = torch.cuda.current_stream(n_valid.device)
    stream.wait_event(ready)
    # The parts were allocated on an upload stream: keep the caching
    # allocator from reusing them while this stream still reads them.
    for t in parts + (n_valid,):
        t.record_stream(stream)
    events = (
        torch.cuda.Event(enable_timing=True),
        torch.cuda.Event(enable_timing=True),
        torch.cuda.Event(),
    )
    events[0].record(stream)
    with torch.inference_mode():
        outs = _core_graph(_decode_payload(transport, parts), n_valid, sr=sr)
        events[1].record(stream)
        # Copies queued here, in stream order after this chunk's graph and
        # before the next chunk's, so a finisher waits for its own chunk
        # only.
        host = tuple(torch.empty(o.shape, dtype=o.dtype, pin_memory=True) for o in outs)
        for h, o in zip(host, outs):
            h.copy_(o, non_blocking=True)
    events[2].record(stream)
    return host, events


def _fetch(outs: tuple, events) -> "list[np.ndarray]":
    """Wait for the chunk's readback (its ``copied`` event) and return the
    outputs as numpy arrays."""

    if events is not None:
        events[2].synchronize()
        _count_stage("graph", events[0].elapsed_time(events[1]) / 1e3)
    return [o.numpy() for o in outs]


def _lane_outputs(fetched: "list[np.ndarray]", k: int, host_exact) -> Dict[str, np.ndarray]:
    """Lane ``k`` of a fetched batch, unpacked, with the host-exact stereo
    values applied ("ms")."""

    out = unpack_outputs(*(f[k] for f in fetched[:4]))
    if len(fetched) > 4:
        out["net_prob"] = fetched[4][k]
    if host_exact is not None:
        _apply_host_stereo_stats(out, *host_exact)
    return out


def analyse_track_fused(
    source: "str | AudioInput",
    *,
    seed: int = DEFAULT_SEED,
    bucket: bool = True,
    transport: str = "auto",
    device_batch: int = 1,
    device: "str | torch.device" = "cuda",
) -> TrackAnalysisResult:
    """Single-track analysis through the batched fused graph, as a batch
    of one, on ``device``.

    ``device`` defaults to "cuda" and raises if CUDA is absent; pass
    "cpu" for the plain PyTorch path.

    ``transport`` picks the host->device representation:
      - "auto" (default): "ms", as in the JAX package.
      - "ms": only the mid channel ships, as blockwise int8 (1 byte per
        stereo sample pair); the time-domain stereo scalars come from
        float64 host sums and the per-band widths from a float64 host
        STFT with the device's band formula. Pads to ``ms_bucket_length``.
      - "ms6": as "ms", the mid as 6-bit codes, per 65 536-sample block
        raw or delta-coded with error feedback, packed four into three
        bytes (0.75 B per stereo sample pair).
      - "ms5": noise-shaped 5-bit codes on 1 024-sample blocks, packed
        eight into five bytes (0.625 B per stereo sample pair).
      - "int8": blockwise-scaled int8 per channel.
      - "int16": -96 dBFS quantisation (lossless for PCM16 sources).
      - "float32": the exact samples.

    ``device_batch`` is accepted for the JAX package's signature, where
    it picks the sweep executable to share; the port compiles no
    executable, so a single track always runs as a batch of one.
    """

    if int(device_batch) < 1:
        raise ValueError(f"device_batch must be >= 1, got {device_batch}")
    if transport == "auto":
        transport = "ms"
    _check_transport(transport)
    dev = resolve_device(device)
    audio = source if isinstance(source, AudioInput) else coerce_audio(source)
    n = len(audio.samples)
    n_bucket = _bucket_for(transport)(n) if bucket else n
    if (transport in _MS_BITS or transport == "int8") and n_bucket % _I8_BLOCK:
        # Blockwise payloads reshape into _I8_BLOCK blocks; bucket=False
        # lengths round up (the padding is masked out).
        n_bucket = -(-n_bucket // _I8_BLOCK) * _I8_BLOCK
    parts, host_exact, n_valid = _stage_track(audio, transport, n_bucket)
    staged = _upload([p[None] for p in parts], [n_valid], dev)
    outs, events = _dispatch(transport, staged, sr=audio.sample_rate)
    fetched = _fetch(outs, events)
    return result_from_graph_outputs(audio, _lane_outputs(fetched, 0, host_exact), seed=seed)


def _kernel_sources() -> "tuple[str, ...]":
    """The CUDA sources the graph will launch: the median kernel always,
    the fused STFT when it is switched on."""

    if fused_stft.switched_on():
        return ("median31.cu", "stft_mag.cu")
    return ("median31.cu",)


def analyse_library(
    sources: Sequence["str | AudioInput"],
    *,
    seed: int = DEFAULT_SEED,
    device: "str | torch.device" = "cuda",
    target_sr: int = DEFAULT_CONFIG.target_sr,
    decode_workers: Optional[int] = None,
    upload_streams: int = 2,
    prefetch_tracks: Optional[int] = None,
    output_dir: "Optional[str | Path]" = None,
    progress_callback: Optional[Callable[[str, int, int], None]] = None,
    manifest_path: "Optional[str | Path]" = None,
    transport: str = "ms",
    on_error: str = "skip",
    prewarm: Optional[bool] = None,
    device_batch: int = 1,
    shard: Optional[tuple] = None,
    report_request: "Optional[ReportRequest]" = None,
) -> "List[TrackAnalysisResult | TrackFailure | SkippedTrack]":
    """Analyse a library of tracks on one device through a bounded
    streaming pipeline.

    Returns one outcome per source, in order: a TrackAnalysisResult, a
    TrackFailure (the track could not be decoded or staged), or a
    SkippedTrack (done in an earlier sweep's manifest, or another shard's).

    Stages, each bounded so memory stays O(prefetch), not O(library):
      decode pool  -> decode + resample + pad + quantise (numpy);
      upload pool  -> pinned staging and non-blocking copies, one side
                      stream per worker, ordered before the dispatch by
                      a CUDA event;
      dispatch     -> one batched graph per chunk of up to
                      ``device_batch`` tracks of one bucket, formed
                      longest first, with its readback into pinned
                      host buffers queued behind it (enqueued, not
                      waited for);
      finish pool  -> waits for the chunk's readback event, then lane
                      by lane unpack and host finishers, manifest.

    ``device``: one card ("cuda", the default, raises without CUDA) or
    "cpu" for the plain path. It takes the place of the JAX package's
    ``mesh``; several cards are not ported yet.

    ``transport``: "ms" (default: mid-only blockwise int8, host-exact
    stereo values; mono and stereo tracks share chunks), "ms6" / "ms5"
    (the mid as packed 6- / 5-bit codes), "int8", "int16" or "float32"
    (exact samples).

    ``manifest_path``: a JSONL manifest makes sweeps resumable: sources it
    lists as done are skipped; failed tracks are recorded with an
    "error" field and retried on the next run.

    ``on_error``: "skip" (default) isolates per-track decode and staging
    failures; "raise" aborts on the first one. A device error always
    propagates.

    ``prewarm``: build the CUDA kernels' libraries while the first tracks
    decode (default: on for a CUDA device). There is no executable to
    compile: the port runs eagerly.

    ``device_batch``: tracks per dispatch. Lanes of one chunk share a
    bucket length; a chunk may hold fewer lanes than ``device_batch``.

    ``shard``: ``(index, count)`` for multi-process sweeps: this process
    analyses ``sources[i]`` where ``i % count == index`` and returns
    SkippedTrack(reason="other-shard") for the rest.

    ``output_dir``: render every track's artefacts
    (``rendering.outputs.render_all``) into a subdirectory of its own,
    named by the source file's stem (``track_<index>`` for a source
    without a path). Plots need matplotlib. ``report_request`` (the
    port's own option) picks the artefacts, e.g.
    ``ReportRequest(include_plots=False)``; None renders them all.

    ``stage_seconds()`` sums each stage's time over the sweep.
    """

    _check_transport(transport)
    if on_error not in ("skip", "raise"):
        raise ValueError(f"on_error must be 'skip' or 'raise', got {on_error!r}")
    if shard is not None:
        shard_index, shard_count = int(shard[0]), int(shard[1])
        if not (0 <= shard_index < shard_count):
            raise ValueError(f"shard index {shard_index} not in [0, {shard_count})")
    dev = resolve_device(device)
    n_lane = max(1, int(device_batch))
    bucket_for = _bucket_for(transport)
    # Decode and staging need the native host library: a failed build
    # raises here, once, and is never recorded as every track's failure.
    native_binding.load()

    done: set[str] = set()
    manifest = Path(manifest_path) if manifest_path else None
    if manifest and manifest.exists():
        for line in manifest.read_text().splitlines():
            try:
                record = json.loads(line)
                if "error" not in record:  # failed tracks retry on rerun
                    done.add(record["source"])
            except (json.JSONDecodeError, KeyError):
                continue

    results: "List[Optional[TrackAnalysisResult | TrackFailure | SkippedTrack]]" = [
        None
    ] * len(sources)
    todo: List[tuple[int, "str | AudioInput"]] = []
    for i, s in enumerate(sources):
        if shard is not None and i % shard_count != shard_index:
            results[i] = SkippedTrack(source=str(s), reason="other-shard")
        elif isinstance(s, (str, Path)) and str(s) in done:
            results[i] = SkippedTrack(source=str(s))
        else:
            todo.append((i, s))

    def _load(item):
        idx, src = item
        try:
            t0 = time.perf_counter()
            audio = coerce_audio(src, target_sr=target_sr)
            t1 = time.perf_counter()
            n_bucket = bucket_for(len(audio.samples))
            payload, host_exact, nv = _stage_track(audio, transport, n_bucket)
            _count_stage("decode", t1 - t0)
            _count_stage("quantise", time.perf_counter() - t1)
        except Exception as exc:
            if on_error == "raise":
                raise
            return idx, src, exc, None, None, None, None
        return idx, src, audio, n_bucket, payload, nv, host_exact

    def _stage(chunk):
        """Upload one chunk's stacked payload parts (on the upload pool)."""

        t0 = time.perf_counter()
        parts = [np.stack([item[3][p] for item in chunk]) for p in range(len(chunk[0][3]))]
        staged = _upload(parts, [item[4] for item in chunk], dev)
        _count_stage("upload", time.perf_counter() - t0)
        return staged

    n_done = 0
    total = len(todo)
    finish_lock = threading.Lock()
    # Rendering is not thread-safe (pyplot mutates a global figure registry
    # and font cache), so artefact writing serialises on its own lock;
    # readback and assembly of other chunks still overlap.
    render_lock = threading.Lock()

    def _record(src, entry: dict) -> None:
        nonlocal n_done
        with finish_lock:
            if manifest:
                with manifest.open("a") as fh:
                    fh.write(json.dumps({"source": str(src), **entry}) + "\n")
            n_done += 1
            if progress_callback:
                progress_callback(str(src), n_done, total)

    def _finish(chunk, outs, events) -> None:
        t0 = time.perf_counter()
        fetched = _fetch(outs, events)
        for k, (idx, src, audio, _payload, _nv, host_exact) in enumerate(chunk):
            result = result_from_graph_outputs(
                audio, _lane_outputs(fetched, k, host_exact), seed=seed
            )
            results[idx] = result
            if output_dir is not None:
                from ..rendering import outputs as outputs_module

                name = Path(str(src)).stem if isinstance(src, (str, Path)) else f"track_{idx:05d}"
                with render_lock:
                    outputs_module.render_all(
                        result, Path(output_dir) / name, report_request=report_request, device=dev
                    )
            _record(src, {"bpm": result.beat.bpm, "key": result.harmonic.primary_key.key})
        _count_stage("finish", time.perf_counter() - t0)

    prefetch = prefetch_tracks or max(2 * n_lane, 4)
    stage_depth = max(upload_streams, 2)
    if decode_workers is None:
        # One core stays free for the dispatch and upload threads.
        decode_workers = max(1, min(4, (os.cpu_count() or 4) - 1))
    decode_pool = ThreadPoolExecutor(max_workers=decode_workers)
    upload_pool = ThreadPoolExecutor(max_workers=upload_streams)
    # One finisher per in-flight chunk plus one, so a finisher is free the
    # moment a chunk is dispatched.
    finish_pool = ThreadPoolExecutor(max_workers=stage_depth + 1)
    warm_pool = ThreadPoolExecutor(max_workers=1)
    if prewarm is None:
        prewarm = dev.type == "cuda"
    warm = warm_pool.submit(cuda_build.build_all, _kernel_sources()) if prewarm else None

    decode_q: deque = deque()  # futures of _load
    buckets: Dict[tuple, list] = {}  # (n_bucket, arity) -> items awaiting a chunk
    staged_q: deque = deque()  # (chunk, future of _stage)
    dispatched_q: deque = deque()  # futures of _finish
    src_iter = iter(todo)

    def _pump_decodes() -> None:
        while len(decode_q) < prefetch:
            item = next(src_iter, None)
            if item is None:
                return
            decode_q.append(decode_pool.submit(_load, item))

    def _absorb(loaded) -> None:
        idx, src, audio, n_bucket, payload, nv, host_exact = loaded
        if isinstance(audio, Exception):
            results[idx] = TrackFailure(source=str(src), error=str(audio))
            _record(src, {"error": str(audio)})
            return
        key = (n_bucket, len(payload))
        buckets.setdefault(key, []).append((idx, src, audio, payload, nv, host_exact))

    def _form_chunks(flush: bool) -> None:
        for key in sorted(buckets):
            items = buckets[key]
            # Longest first within a bucket, as the reference forms chunks.
            items.sort(key=lambda it: -it[4])
            while len(items) >= n_lane or (flush and items):
                chunk, items = items[:n_lane], items[n_lane:]
                buckets[key] = items
                staged_q.append((chunk, upload_pool.submit(_stage, chunk)))

    try:
        _pump_decodes()
        while True:
            while decode_q and decode_q[0].done():
                _absorb(decode_q.popleft().result())
                _pump_decodes()
            _form_chunks(flush=not decode_q)

            if not staged_q:
                if decode_q:  # nothing uploadable yet: block on decode
                    _absorb(decode_q.popleft().result())
                    _pump_decodes()
                    continue
                if any(buckets.values()):  # trailing partial chunks
                    _form_chunks(flush=True)
                    continue
                break  # everything dispatched

            chunk, staged_future = staged_q.popleft()
            staged = staged_future.result()
            if warm is not None:
                warm.result()  # a kernel that does not build raises here
                warm = None
            t0 = time.perf_counter()
            outs, events = _dispatch(transport, staged, sr=target_sr)
            _count_stage("dispatch", time.perf_counter() - t0)
            dispatched_q.append(finish_pool.submit(_finish, chunk, outs, events))
            while len(dispatched_q) > stage_depth:
                dispatched_q.popleft().result()
        while dispatched_q:
            dispatched_q.popleft().result()
    finally:
        decode_pool.shutdown(wait=True)
        upload_pool.shutdown(wait=True)
        finish_pool.shutdown(wait=True)
        warm_pool.shutdown(wait=True)

    return results
