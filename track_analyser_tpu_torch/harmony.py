"""Harmony results and host finishers: key, chord hints, change points,
MIDI seeds, and the per-module device graphs.

The Krumhansl-Schmuckler profiles, the 24-key scoring, the 60 chord
templates (12 roots x maj/min/dim/sus2/sus4) with a deterministic rng
tie-break, cosine chord-change points, and the scale-degree MIDI
sketches of the JAX package's ``harmony.py``. The fused path takes its
key scores from the fused graph; ``analyse_harmony`` (the per-module
path) runs its own graphs on the caller's device: both chroma
projections, the spectral balance and the stereo image, each over the
signal padded to the fused graph's bucket.

``MidiSuggestion.notes`` is a ``dict[str, np.ndarray]`` with the columns
of the JAX package's ``pd.DataFrame`` (start, duration, pitch, velocity,
channel): the port does not depend on pandas.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .analysis.beats import BeatAnalysis, DownbeatAnalysis
from .config import DEFAULT_CONFIG
from .device import check_nans, resolve_device
from .ops.chroma import chroma_from_power, chroma_stft_filterbank, cq_chroma_tribank
from .ops.stft import magnitude
from .utils import AudioInput, deterministic_rng, seed_everything

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
    "analyse_harmony",
    "key_estimate",
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
# Device graphs
# ---------------------------------------------------------------------------


def _chroma_graph(y: torch.Tensor, *, sr: int, hop_length: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both chroma projections of ``y`` from one 2048-point |STFT|: the
    three-resolution CQ chroma, repeated from its coarse hop up to
    ``hop_length`` frames, and the STFT chroma."""

    cfg = DEFAULT_CONFIG
    stft_mag = magnitude(y, 2048, hop_length, power=1.0)
    stft_power = stft_mag * stft_mag
    chroma_stft = chroma_from_power(stft_power, chroma_stft_filterbank(sr, 2048))
    chroma_cq = cq_chroma_tribank(
        y,
        stft_mag,
        sr=sr,
        hop=cfg.cq_hop,
        family_n_fft=2048,
        family_hop=hop_length,
        low_n_fft=cfg.cq_low_n_fft,
        mid_n_fft=cfg.cq_mid_n_fft,
        decim=cfg.cq_decim,
        low_octaves=cfg.cq_low_octaves,
        family_octave=cfg.cq_family_octave,
        keep_hz=cfg.cq_keep_hz,
    )
    chroma_cq = torch.repeat_interleave(chroma_cq, cfg.cq_hop // hop_length, dim=-1)[
        ..., : stft_power.shape[-1]
    ]
    return chroma_cq, chroma_stft


def _balance_graph(y: torch.Tensor, *, sr: int, n_fft: int, hop_length: int) -> torch.Tensor:
    """(total, low, mid, high) magnitude sums over the balance bands."""

    from .ops.spectral import balance_band_weights

    spec = magnitude(y, n_fft, hop_length, power=1.0)
    w = torch.as_tensor(balance_band_weights(sr, n_fft), device=y.device)
    sums = w @ spec.sum(dim=-1)
    return torch.cat([sums.sum()[None], sums])


def _compute_chromas(
    y: np.ndarray, sr: int, hop_length: int = 512, *, device="cuda"
) -> Tuple[np.ndarray, np.ndarray]:
    """Both chroma matrices (CQ, STFT) as float64, over the signal padded
    to the fused graph's bucket and trimmed to the true frame count
    (chroma columns are per frame, so the trim is exact)."""

    from .substrate import pad_to_bucket

    dev = resolve_device(device)
    padded, f_valid = pad_to_bucket(y, hop=hop_length)
    with torch.inference_mode():
        cq, st = check_nans(
            "harmony._chroma_graph",
            _chroma_graph(torch.from_numpy(padded).to(dev), sr=sr, hop_length=hop_length),
        )
    return (
        cq.cpu().numpy().astype(np.float64)[:, :f_valid],
        st.cpu().numpy().astype(np.float64)[:, :f_valid],
    )


def _spectral_balance(audio: AudioInput, *, device="cuda") -> SpectralBalance:
    from .substrate import pad_to_bucket

    dev = resolve_device(device)
    padded, _ = pad_to_bucket(audio.samples)
    with torch.inference_mode():
        sums = _balance_graph(
            torch.from_numpy(padded).to(dev),
            sr=audio.sample_rate,
            n_fft=DEFAULT_CONFIG.balance_n_fft,
            hop_length=DEFAULT_CONFIG.balance_hop,
        )
        sums = check_nans("harmony._balance_graph", sums).cpu().numpy()
    total, low, mid, high = (float(v) for v in sums)
    if total <= 0:
        return SpectralBalance(0.0, 0.0, 0.0)
    return SpectralBalance(low_band=low / total, mid_band=mid / total, high_band=high / total)


def _stereo_image_graph(lr: torch.Tensor, n_valid: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Centered L/R correlation and |L| - |R| balance of the first
    ``n_valid`` samples of the padded pair ``lr`` (2, n)."""

    zero = torch.zeros((), dtype=lr.dtype, device=lr.device)
    mask = torch.arange(lr.shape[-1], device=lr.device) < n_valid
    count = torch.tensor(float(max(n_valid, 1)), dtype=lr.dtype, device=lr.device)
    left = torch.where(mask, lr[0], zero)
    right = torch.where(mask, lr[1], zero)
    lc = torch.where(mask, left - left.sum() / count, zero)
    rc = torch.where(mask, right - right.sum() / count, zero)
    denom = torch.sqrt((lc * lc).sum()) * torch.sqrt((rc * rc).sum())
    ok = denom > 1e-12
    corr = torch.clamp(torch.dot(lc, rc) / torch.where(ok, denom, torch.ones_like(denom)), -1.0, 1.0)
    corr = torch.where(ok, corr, torch.ones_like(corr))
    balance = (left.abs().sum() - right.abs().sum()) / count
    return corr, balance


def _stereo_image(audio: AudioInput, *, device="cuda") -> StereoImage:
    samples = audio.stereo_samples if audio.stereo_samples is not None else audio.samples
    samples = np.asarray(samples, dtype=np.float32)
    if samples.ndim != 2 or samples.shape[0] < 2 or samples.shape[-1] == 0:
        return StereoImage(correlation=1.0, balance=0.0)
    from .substrate import pad_to_bucket

    dev = resolve_device(device)
    padded, _ = pad_to_bucket(samples[:2])
    with torch.inference_mode():
        corr, balance = check_nans(
            "harmony._stereo_image_graph",
            _stereo_image_graph(torch.from_numpy(padded).to(dev), samples.shape[-1]),
        )
    return StereoImage(correlation=float(corr), balance=float(balance))


# ---------------------------------------------------------------------------
# Key scoring and decision
# ---------------------------------------------------------------------------


@lru_cache(maxsize=1)
def _profile_matrices() -> Tuple[np.ndarray, np.ndarray]:
    """Rows: all 12 rotations of the normalised K-S profiles."""

    major = MAJOR_PROFILE / np.linalg.norm(MAJOR_PROFILE)
    minor = MINOR_PROFILE / np.linalg.norm(MINOR_PROFILE)
    maj_rot = np.stack([np.roll(major, s) for s in range(12)])
    min_rot = np.stack([np.roll(minor, s) for s in range(12)])
    return maj_rot, min_rot


def _correlate_chroma(chroma: np.ndarray, template: np.ndarray) -> np.ndarray:
    """All 12 rotations of dot(chroma, template) as one matmul."""

    rotations = np.stack([np.roll(template, shift) for shift in range(12)])
    return rotations @ np.asarray(chroma, dtype=float)


def _score_keys(chroma_matrices: Sequence[np.ndarray]) -> Tuple[np.ndarray, List[str]]:
    if not chroma_matrices:
        return np.array([]), []

    keys = [
        f"{pitch} {mode}" for mode in ("major", "minor") for pitch in PITCH_CLASS_NAMES
    ]
    profile = np.concatenate(_profile_matrices(), axis=0)  # (24, 12)
    aggregated = np.zeros(24, dtype=float)
    for chroma in chroma_matrices:
        if chroma.size == 0:
            continue
        mean = np.mean(chroma, axis=1)
        norm = np.linalg.norm(mean)
        if norm > 0:
            aggregated += profile @ (mean / norm)
    return aggregated, keys


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


def key_estimate(y: np.ndarray, sr: int, *, device="cuda") -> KeyEstimation:
    """Best and second-best key hypotheses from combined chroma evidence."""

    chroma_cq, chroma_stft = _compute_chromas(np.asarray(y, dtype=np.float32), sr, device=device)
    scores, keys = _score_keys([chroma_cq, chroma_stft])
    return _keys_from_scores(scores, keys)


def _estimate_keys_from_chroma(chroma_cqt: np.ndarray, chroma_stft: np.ndarray) -> KeyEstimation:
    scores, keys = _score_keys([chroma_cqt, chroma_stft])
    return _keys_from_scores(scores, keys)


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


def _build_chord_templates() -> Dict[str, np.ndarray]:
    matrix, names = _chord_template_matrix()
    return dict(zip(names, matrix))


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


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------


def analyse_harmony(
    audio: AudioInput,
    beat_result: BeatAnalysis,
    downbeat_result: Optional[DownbeatAnalysis],
    *,
    seed: int,
    device="cuda",
) -> HarmonyAnalysis:
    """Key, chords, change points, balance, stereo image and the two MIDI
    sketches of ``audio``, its graphs on ``device``."""

    if not isinstance(audio, AudioInput):
        raise TypeError("analyse_harmony expects an AudioInput instance")

    seed_everything(seed)
    rng = deterministic_rng(seed)

    spectral_balance = _spectral_balance(audio, device=device)
    stereo_image = _stereo_image(audio, device=device)

    chroma_cqt, chroma_stft = _compute_chromas(audio.samples, audio.sample_rate, device=device)
    key_result = _estimate_keys_from_chroma(chroma_cqt, chroma_stft)

    chord_hints = _estimate_chords(chroma_cqt, beat_result, rng)
    change_points = _detect_chord_changes(chroma_cqt, beat_result, chord_hints)

    if downbeat_result and downbeat_result.downbeat_times:
        start_offset = downbeat_result.downbeat_times[0]
    else:
        start_offset = beat_result.beat_times[0] if beat_result.beat_times else 0.0

    sketches = {
        name: _generate_midi(
            chroma_cqt, beat_result, key_result.best, rng,
            name=name, octave=octave, start_offset=start_offset,
        )
        for name, octave in (("hook", 0), ("bass", -1))
    }

    return HarmonyAnalysis(
        spectral_balance=spectral_balance,
        stereo_image=stereo_image,
        primary_key=key_result.best,
        secondary_key=key_result.second_best,
        chord_hints=chord_hints,
        chord_change_points=change_points,
        hook_suggestion=sketches["hook"],
        bass_suggestion=sketches["bass"],
    )
