"""Structural segmentation via a combined novelty curve.

The JAX package's ``analysis/structure.py``: the device graph
(``_structure_graph``: |STFT|, HPSS through the ``median31`` kernel, mel,
MFCC self-similarity, the combined novelty; the curves themselves are
``substrate.structure_curves``, the fused graph's own function) and the
host finisher (peak picking on the combined novelty with an 8 s minimum
spacing, refinement against energy novelty, beat snapping, and the
percussive-ratio segment classifier).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

import numpy as np
import torch

from ..config import DEFAULT_CONFIG
from ..device import check_nans, resolve_device
from ..ops.peaks import peak_pick
from ..utils import AudioInput, seed_everything
from .beats import BeatAnalysis

__all__ = [
    "StructuralSegment",
    "StructureAnalysis",
    "analyse_structure",
    "segments_from_curves",
]


@dataclass(slots=True)
class StructuralSegment:
    label: str
    category: str
    start: float
    end: float
    confidence: float
    percussive_energy: float
    harmonic_energy: float
    percussive_ratio: float


@dataclass(slots=True)
class StructureAnalysis:
    segments: List[StructuralSegment]
    novelty_curve: List[float]


def _structure_graph(
    y: torch.Tensor, n_valid: int, *, sr: int, frame_length: int, hop_length: int
) -> tuple:
    """Device portion for one bucket-padded signal ``y`` (n,) with
    ``n_valid`` true samples: (novelty, normalised energy novelty,
    percussive column sums, harmonic column sums), each (T,) and zero
    beyond the valid frames. HPSS launches ``median31`` once per axis."""

    from ..ops.mel import mel_filterbank, melspectrogram_from_power
    from ..ops.onset import onset_strength_from_mel
    from ..ops.stft import magnitude
    from ..substrate import structure_curves

    mag = magnitude(y[None], frame_length, hop_length, power=1.0)  # (1, bins, T)
    mel_power = melspectrogram_from_power(mag * mag, mel_filterbank(sr, frame_length, DEFAULT_CONFIG.n_mels))
    f_valid = torch.tensor([1 + n_valid // hop_length], device=y.device)
    fmask = torch.arange(mag.shape[-1], device=y.device) < f_valid[:, None]
    env = onset_strength_from_mel(mel_power, n_fft=frame_length, hop_length=hop_length)
    env = torch.where(fmask, env, torch.zeros((), dtype=env.dtype, device=y.device))
    curves = structure_curves(mag, mel_power, env, f_valid, sr=sr, hop=hop_length)
    return tuple(c[0] for c in curves)


def analyse_structure(
    audio: AudioInput,
    beat_result: BeatAnalysis,
    *,
    seed: int,
    frame_length: int = 2048,
    hop_length: int = 512,
    device="cuda",
) -> StructureAnalysis:
    """Detect structural boundaries using the combined novelty heuristic,
    the graph on ``device``."""

    if not isinstance(audio, AudioInput):
        raise TypeError("analyse_structure expects an AudioInput instance")
    seed_everything(seed)

    from ..substrate import pad_to_bucket

    dev = resolve_device(device)
    y = np.asarray(audio.samples, dtype=np.float32)
    padded, f_valid = pad_to_bucket(y, hop=hop_length)
    with torch.inference_mode():
        outs = _structure_graph(
            torch.from_numpy(padded).to(dev),
            y.size,
            sr=audio.sample_rate,
            frame_length=frame_length,
            hop_length=hop_length,
        )
        check_nans("analysis.structure._structure_graph", outs)
        novelty, energy_novelty, perc_col, harm_col = (
            o.cpu().numpy().astype(np.float64)[:f_valid] for o in outs
        )
    return segments_from_curves(
        novelty,
        energy_novelty,
        perc_col,
        harm_col,
        beat_result,
        sample_rate=audio.sample_rate,
        hop_length=hop_length,
        duration=float(audio.duration),
    )


def segments_from_curves(
    novelty: np.ndarray,
    energy_novelty: np.ndarray,
    perc_col: np.ndarray,
    harm_col: np.ndarray,
    beat_result: BeatAnalysis,
    *,
    sample_rate: int,
    hop_length: int,
    duration: float,
) -> StructureAnalysis:
    """Host finisher: peak picking + segment assembly from device curves.

    Shared by the single-track pipeline and the batched library path.
    """

    if novelty.size == 0:
        fallback_segment = StructuralSegment(
            label="A",
            category="intro",
            start=0.0,
            end=duration,
            confidence=0.0,
            percussive_energy=float(np.sum(perc_col)),
            harmonic_energy=float(np.sum(harm_col)),
            percussive_ratio=0.0,
        )
        return StructureAnalysis(segments=[fallback_segment], novelty_curve=novelty.tolist())

    frames_per_second = sample_rate / float(hop_length)
    min_spacing_seconds = DEFAULT_CONFIG.min_segment_spacing_seconds
    min_spacing_frames = max(1, int(round(min_spacing_seconds * frames_per_second)))
    peaks = peak_pick(
        novelty,
        pre_max=8,
        post_max=8,
        pre_avg=32,
        post_avg=32,
        delta=float(np.std(novelty)) * 0.4,
        wait=min_spacing_frames,
    )

    peaks = _refine_boundaries(
        peaks, energy_novelty, int(round(frames_per_second * DEFAULT_CONFIG.boundary_refine_seconds))
    )
    peaks = _enforce_min_frame_spacing(peaks, novelty, min_spacing_frames)
    total_frames = len(novelty)
    boundaries = np.concatenate(([0], peaks, [total_frames - 1]))
    boundaries = np.asarray(np.unique(boundaries), dtype=int)
    times = boundaries.astype(float) * hop_length / sample_rate

    if beat_result.beat_times:
        beat_times = np.asarray(beat_result.beat_times)
        snapped = beat_times[np.argmin(np.abs(beat_times[None, :] - times[:, None]), axis=1)]
        snapped = np.maximum.accumulate(snapped)
        spacing_mask = _enforce_min_time_spacing(snapped, boundaries, novelty, min_spacing_seconds)
        times = snapped[spacing_mask]
        boundaries = boundaries[spacing_mask]
    else:
        spacing_mask = _enforce_min_time_spacing(times, boundaries, novelty, min_spacing_seconds)
        times = times[spacing_mask]
        boundaries = boundaries[spacing_mask]

    labels = _label_segments(len(boundaries) - 1)
    perc_cum = np.concatenate(([0.0], np.cumsum(perc_col)))
    harm_cum = np.concatenate(([0.0], np.cumsum(harm_col)))
    novelty_max = float(np.max(novelty))

    segment_ratio: List[float] = []
    segment_percussive: List[float] = []
    segment_harmonic: List[float] = []
    segments: List[StructuralSegment] = []
    for idx, start_idx in enumerate(boundaries[:-1]):
        end_idx = boundaries[idx + 1]
        window = novelty[start_idx:end_idx]
        seg_novelty = float(np.mean(window)) if window.size else 0.0
        perc_energy = float(perc_cum[end_idx] - perc_cum[start_idx])
        harm_energy = float(harm_cum[end_idx] - harm_cum[start_idx])
        ratio = float(perc_energy / (perc_energy + harm_energy + 1e-9))
        segment_percussive.append(perc_energy)
        segment_harmonic.append(harm_energy)
        segment_ratio.append(ratio)
        segments.append(
            StructuralSegment(
                label=labels[idx],
                category="",
                start=float(times[idx]),
                end=float(times[idx + 1]),
                confidence=float(np.clip(seg_novelty / (novelty_max + 1e-9), 0.0, 1.0)),
                percussive_energy=perc_energy,
                harmonic_energy=harm_energy,
                percussive_ratio=ratio,
            )
        )

    categories = _classify_segments(segment_ratio, segment_percussive, segment_harmonic)
    for segment, category in zip(segments, categories):
        segment.category = category

    return StructureAnalysis(segments=segments, novelty_curve=novelty.tolist())


def _label_segments(count: int) -> List[str]:
    alphabet = "ABCDEFGHIJKLMNOPQRSTUVWXYZ"
    return [alphabet[idx % len(alphabet)] for idx in range(count)]


def _refine_boundaries(
    peaks: np.ndarray, energy_novelty: np.ndarray, search_radius: int
) -> np.ndarray:
    """Snap each peak to the strongest energy-novelty frame within ±radius
    — one (peaks, window) gather + argmax instead of a per-peak loop
    (the original track-analyser's recipe)."""

    if peaks.size == 0 or energy_novelty.size == 0:
        return np.asarray(peaks, dtype=int)
    radius = max(1, int(search_radius))
    windows = np.clip(
        np.asarray(peaks, dtype=int)[:, None] + np.arange(-radius, radius + 1)[None, :],
        0,
        energy_novelty.shape[0] - 1,
    )
    best = np.argmax(energy_novelty[windows], axis=1)
    return windows[np.arange(peaks.size), best].astype(int)


def _resolve_conflicts(candidates, too_close, stronger) -> List[int]:
    """Shared greedy sweep for both spacing passes: walk the ordered
    candidates; a candidate too close to the last keep either replaces it
    (when stronger) or drops."""

    kept: List[int] = []
    for cand in candidates:
        if kept and too_close(kept[-1], cand):
            if stronger(kept[-1], cand):
                kept[-1] = cand
        else:
            kept.append(cand)
    return kept


def _enforce_min_frame_spacing(
    peaks: np.ndarray, novelty: np.ndarray, min_spacing: int
) -> np.ndarray:
    if peaks.size == 0:
        return peaks
    kept = _resolve_conflicts(
        [int(p) for p in np.sort(peaks)],
        too_close=lambda prev, cur: cur - prev < min_spacing,
        stronger=lambda prev, cur: novelty[cur] > novelty[prev],
    )
    return np.asarray(kept, dtype=int)


def _enforce_min_time_spacing(
    times: Sequence[float],
    frames: Sequence[int],
    novelty: np.ndarray,
    min_spacing_seconds: float,
) -> np.ndarray:
    """Keep-mask over boundary times; both track ends always survive, and
    a boundary crowding the track START drops rather than replacing it."""

    times = np.asarray(times, dtype=float)
    frames = np.asarray(frames, dtype=int)
    if times.size == 0:
        return np.zeros(0, dtype=bool)
    if times.size <= 2:
        return np.ones(times.shape, dtype=bool)

    interior = _resolve_conflicts(
        [0, *range(1, times.size - 1)],
        too_close=lambda prev, cur: times[cur] - times[prev] < min_spacing_seconds,
        stronger=lambda prev, cur: prev != 0 and novelty[frames[cur]] > novelty[frames[prev]],
    )
    mask = np.zeros(times.shape, dtype=bool)
    mask[interior] = True
    mask[0] = mask[-1] = True
    return mask


# (condition, category) rules for interior segments, first match wins;
# thresholds are the original track-analyser's. e = segment
# energy, m = median segment energy, r = percussive ratio.
_CATEGORY_RULES = (
    (lambda r, e, m: e < 0.5 * m and r < 0.35, "breakdown"),
    (lambda r, e, m: r > 0.65 and e >= 0.75 * m, "drop"),
    (lambda r, e, m: r > 0.45, "groove"),
    (lambda r, e, m: r < 0.35, "breakdown"),
    (lambda r, e, m: True, "bridge"),
)


def _classify_segments(
    percussive_ratios: Sequence[float],
    percussive_energy: Sequence[float],
    harmonic_energy: Sequence[float],
) -> List[str]:
    """Rule-based intro/outro/drop/groove/breakdown/bridge classifier."""

    ratios = np.asarray(percussive_ratios, dtype=float)
    total = np.asarray(percussive_energy, dtype=float) + np.asarray(
        harmonic_energy, dtype=float
    )
    if total.size == 0:
        return []
    # Compare energies against the median directly: substituting 1.0 for a zero median
    # would flip drop/breakdown decisions on near-silent tracks where
    # 'e >= 0.75 * 0' is trivially true in the original.
    median_energy = float(np.median(total))

    def interior(r: float, e: float) -> str:
        return next(
            cat
            for rule, cat in _CATEGORY_RULES
            if rule(r, e, median_energy)
        )

    last = ratios.size - 1
    return [
        "intro" if i == 0 else "outro" if i == last else interior(r, e)
        for i, (r, e) in enumerate(zip(ratios, total))
    ]
