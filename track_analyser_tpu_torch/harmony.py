"""Harmony results and host finishers: key, chord hints, change points,
MIDI seeds (numpy).

The Krumhansl-Schmuckler profiles, the 24-key score decision, the 60
chord templates (12 roots x maj/min/dim/sus2/sus4) with a deterministic
rng tie-break, cosine chord-change points, and the scale-degree MIDI
sketches of the JAX package's ``harmony.py``. The key scores themselves
come from the fused graph; the per-module chroma graphs are not ported
yet.

``MidiSuggestion.notes`` is a ``dict[str, np.ndarray]`` with the columns
of the JAX package's ``pd.DataFrame`` (start, duration, pitch, velocity,
channel): the port does not depend on pandas.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import Dict, List, Sequence, Tuple

import numpy as np

from .analysis.beats import BeatAnalysis
from .config import DEFAULT_CONFIG

MAJOR_PROFILE = np.array(
    [6.35, 2.23, 3.48, 2.33, 4.38, 4.09, 2.52, 5.19, 2.39, 3.66, 2.29, 2.88]
)
MINOR_PROFILE = np.array(
    [6.33, 2.68, 3.52, 5.38, 2.6, 3.53, 2.54, 4.75, 3.98, 2.69, 3.34, 3.17]
)
PITCH_CLASS_NAMES = "C C# D Eb E F F# G Ab A Bb B".split()

__all__ = [
    "HarmonyAnalysis",
    "ChordChangePoint",
    "ChordHint",
    "KeyEstimation",
    "KeyEstimate",
    "MidiSuggestion",
    "SpectralBalance",
    "StereoImage",
    "MAJOR_PROFILE",
    "MINOR_PROFILE",
    "PITCH_CLASS_NAMES",
]


@dataclass(slots=True)
class SpectralBalance:
    low_band: float
    mid_band: float
    high_band: float


@dataclass(slots=True)
class StereoImage:
    correlation: float
    balance: float


@dataclass(slots=True)
class KeyEstimate:
    key: str
    confidence: float


@dataclass(slots=True)
class KeyEstimation:
    best: KeyEstimate
    second_best: KeyEstimate


@dataclass(slots=True)
class ChordHint:
    time: float
    chord: str
    confidence: float


@dataclass(slots=True)
class ChordChangePoint:
    time: float
    strength: float


@dataclass(slots=True)
class MidiSuggestion:
    """A MIDI sketch. ``notes`` maps column name (start, duration, pitch,
    velocity, channel) to an equal-length array; the JAX package holds the
    same columns in a ``pd.DataFrame``."""

    name: str
    notes: Dict[str, np.ndarray]


@dataclass(slots=True)
class HarmonyAnalysis:
    spectral_balance: SpectralBalance
    stereo_image: StereoImage
    primary_key: KeyEstimate
    secondary_key: KeyEstimate
    chord_hints: List[ChordHint]
    chord_change_points: List[ChordChangePoint]
    hook_suggestion: MidiSuggestion
    bass_suggestion: MidiSuggestion

    @property
    def key_estimate(self) -> KeyEstimate:
        """Backward compatible accessor for the best key estimate."""

        return self.primary_key


# ---------------------------------------------------------------------------
# Key decision
# ---------------------------------------------------------------------------


def _keys_from_scores(scores: np.ndarray, keys: List[str]) -> KeyEstimation:
    if not scores.size:
        fallback = KeyEstimate(key="C major", confidence=0.0)
        return KeyEstimation(best=fallback, second_best=fallback)

    confidences = np.maximum(scores, 0.0)
    confidences = confidences / (float(confidences.sum()) or 1.0)
    first, second = np.argsort(confidences)[::-1][:2]
    return KeyEstimation(
        best=KeyEstimate(key=keys[first], confidence=float(confidences[first])),
        second_best=KeyEstimate(key=keys[second], confidence=float(confidences[second])),
    )


# ---------------------------------------------------------------------------
# Beat-synchronous chroma profiles, chords, change points
# ---------------------------------------------------------------------------


def _beat_chroma_profiles(
    chroma: np.ndarray, beat_frames: Sequence[int], window: int = 2
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-beat L2-normalised mean chroma over frames [f-window, f+window).

    Returns (profiles (B, 12), valid mask (B,)); invalid = empty window or
    zero-norm.
    """

    frames = np.asarray(beat_frames, dtype=int)
    n = chroma.shape[1]
    if frames.size == 0 or n == 0:
        return np.zeros((0, 12)), np.zeros(0, dtype=bool)
    cs = np.concatenate([np.zeros((chroma.shape[0], 1)), np.cumsum(chroma, axis=1)], axis=1)
    lo = np.clip(frames - window, 0, n)
    hi = np.clip(frames + window, 0, n)
    counts = np.maximum(hi - lo, 1)
    sums = cs[:, hi] - cs[:, lo]
    means = (sums / counts).T  # (B, 12)
    norms = np.linalg.norm(means, axis=1)
    valid = (hi > lo) & (norms > 0)
    safe = np.where(norms > 0, norms, 1.0)
    return means / safe[:, None], valid


# Chord vocabulary: 12 roots x five qualities (semitone offsets).
_CHORD_INTERVALS = {
    "maj": (0, 4, 7),
    "min": (0, 3, 7),
    "dim": (0, 3, 6),
    "sus2": (0, 2, 7),
    "sus4": (0, 5, 7),
}


@lru_cache(maxsize=1)
def _chord_template_matrix() -> Tuple[np.ndarray, List[str]]:
    """(60, 12) L2-normalised binary templates + their names."""

    eye = np.eye(12)
    rows, names = [], []
    for root, pitch in enumerate(PITCH_CLASS_NAMES):
        for quality, offsets in _CHORD_INTERVALS.items():
            rows.append(eye[[(root + o) % 12 for o in offsets]].sum(axis=0))
            names.append(f"{pitch}{quality}")
    matrix = np.stack(rows)
    matrix /= np.linalg.norm(matrix, axis=1, keepdims=True)
    return matrix, names


def _estimate_chords(
    chroma: np.ndarray,
    beat_result: BeatAnalysis,
    rng: np.random.Generator,
) -> List[ChordHint]:
    """Best chord per beat: one (beats x 12) @ (12 x 60) matmul with a
    deterministic rng tie-break; confidence = winning score over the
    beat's max."""

    beat_frames = beat_result.beat_frames
    if not beat_frames:
        return []
    profiles, valid = _beat_chroma_profiles(
        chroma, beat_frames, DEFAULT_CONFIG.chord_window_frames
    )
    matrix, names = _chord_template_matrix()
    scores = profiles @ matrix.T  # (B, 60)
    best = np.argmax(scores + rng.normal(0.0, 1e-6, size=scores.shape), axis=1)
    winning = scores[np.arange(best.size), best]
    confidence = winning / (scores.max(axis=1) + 1e-9)
    times = np.asarray(beat_result.beat_times, dtype=float)
    return [
        ChordHint(time=float(times[i]), chord=names[best[i]], confidence=float(confidence[i]))
        for i in np.flatnonzero(valid)
    ]


def _detect_chord_changes(
    chroma: np.ndarray, beat_result: BeatAnalysis, chord_hints: Sequence[ChordHint]
) -> List[ChordChangePoint]:
    """Chord-change points from two evidence arrays, merged.

    A: cosine novelty between consecutive beat chroma profiles (the top
    ``chord_change_keep_fraction`` above the configured floor, plus the
    first transition). B: template distance across chord-hint transitions
    where the hint moved. Duplicate times keep the max strength; output
    is normalised to max=1.
    """

    beat_frames = beat_result.beat_frames
    if len(beat_frames) < 2:
        return []

    profiles, valid = _beat_chroma_profiles(
        chroma, beat_frames, DEFAULT_CONFIG.chord_window_frames
    )
    kept = np.flatnonzero(valid)
    if kept.size < 2:
        return []
    profiles = profiles[kept]
    times = np.asarray(beat_result.beat_times, dtype=float)[kept]

    similarity = np.clip(np.einsum("ij,ij->i", profiles[:-1], profiles[1:]), -1.0, 1.0)
    strengths = np.clip(1.0 - similarity, 0.0, 1.0)

    keep = max(1, int(np.ceil(strengths.size * DEFAULT_CONFIG.chord_change_keep_fraction)))
    if keep >= strengths.size:
        threshold = float(strengths.min())
    else:
        cut = strengths.size - keep
        threshold = float(np.partition(strengths, cut)[cut])
    threshold = max(threshold, DEFAULT_CONFIG.chord_change_threshold)

    select = strengths >= threshold
    select[0] = True
    cand_times = [times[1:][select]]
    cand_strengths = [strengths[select]]

    if len(chord_hints) >= 2:
        matrix, names = _chord_template_matrix()
        row_of = {name: i for i, name in enumerate(names)}
        rows = np.array([row_of.get(h.chord, -1) for h in chord_hints], dtype=int)
        labels = np.array([h.chord for h in chord_hints])
        moved = labels[1:] != labels[:-1]
        prev_rows, curr_rows = rows[:-1], rows[1:]
        known = (prev_rows >= 0) & (curr_rows >= 0)
        sim = np.zeros(prev_rows.size)  # unknown template pairs score 0
        sim[known] = np.clip(
            np.einsum("ij,ij->i", matrix[prev_rows[known]], matrix[curr_rows[known]]),
            -1.0,
            1.0,
        )
        hint_times = np.array([h.time for h in chord_hints], dtype=float)
        cand_times.append(hint_times[1:][moved])
        cand_strengths.append(np.clip(1.0 - sim[moved], 0.0, 1.0))

    all_times = np.concatenate(cand_times)
    all_strengths = np.concatenate(cand_strengths)
    if all_times.size == 0:
        return []
    uniq, inverse = np.unique(all_times, return_inverse=True)
    merged = np.zeros(uniq.size)
    np.maximum.at(merged, inverse, all_strengths)
    scale = float(merged.max()) or 1.0
    return [
        ChordChangePoint(time=float(t), strength=float(s / scale))
        for t, s in zip(uniq, merged)
    ]


# ---------------------------------------------------------------------------
# MIDI suggestion
# ---------------------------------------------------------------------------


# Diatonic scale-degree offsets by mode (semitones above the root).
_MODE_STEPS = {
    "major": np.array([0, 2, 4, 5, 7, 9, 11]),
    "minor": np.array([0, 2, 3, 5, 7, 8, 10]),
}


def _scale_for_key(key: str) -> List[int]:
    root, _, mode = key.partition(" ")
    steps = _MODE_STEPS["major" if mode.strip().lower().startswith("major") else "minor"]
    return list((PITCH_CLASS_NAMES.index(root) + steps) % 12)


def _generate_midi(
    chroma: np.ndarray,
    beat_result: BeatAnalysis,
    key_estimate_: KeyEstimate,
    rng: np.random.Generator,
    *,
    name: str,
    octave: int = 0,
    start_offset: float = 0.0,
) -> MidiSuggestion:
    """Eight-beat scale-degree sketch in the detected key; the random
    draws are batched, one integers() call per column."""

    scale = np.asarray(_scale_for_key(key_estimate_.key), dtype=int)
    beats = np.maximum(
        np.asarray(beat_result.beat_times[:8], dtype=float) - start_offset, 0.0
    )
    if beats.size == 0:
        beats = np.array([0.0, 0.5, 1.0, 1.5])
    duration = float(np.median(np.diff(beats))) if beats.size > 1 else 0.5
    degrees = rng.integers(0, scale.size, size=beats.size)
    velocities = np.clip(96 + rng.integers(-12, 12, size=beats.size), 20, 127)
    notes = {
        "start": beats,
        "duration": np.full(beats.size, duration),
        "pitch": 60 + scale[degrees] + 12 * octave,
        "velocity": velocities.astype(int),
        "channel": np.zeros(beats.size, dtype=int),
    }
    return MidiSuggestion(name=name, notes=notes)
