"""Beat and downbeat estimation.

The ``BeatAnalysis`` / ``DownbeatAnalysis`` dataclasses of the JAX
package, the inter-beat-interval confidence formula, the every-4th-beat
fallback for downbeats, and the per-module entry points
(``analyse_beats``, ``analyse_downbeats``, ``tracked_times_for``), whose
graphs run on the caller's device.

The downbeat ladder steps down where its inputs run out: fewer than 4
beats (the decoder returns None) gives the heuristic, and fewer than 8
tracked beats makes the constant grid the decoder's time base. A device
or kernel error propagates; the JAX package swallows every exception
here.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..utils import AudioInput, seed_everything

__all__ = [
    "BeatAnalysis",
    "DownbeatAnalysis",
    "analyse_beats",
    "analyse_downbeats",
    "build_beat_analysis",
    "tracked_times_for",
]


@dataclass(slots=True)
class BeatAnalysis:
    """Summary of the beat grid.

    ``beat_times`` is the constant-tempo grid; ``tracked_times`` the
    drift-following DP beat sequence (None when the envelope is
    degenerate). ``grid`` is a ``dict[str, np.ndarray]`` with the columns
    time, frame, bar, beat, is_downbeat; the JAX package keeps the same
    columns in a ``pd.DataFrame``.
    """

    bpm: float
    beat_times: List[float]
    beat_frames: List[int]
    confidence: float
    grid: Optional[Dict[str, np.ndarray]] = None
    tracked_times: Optional[List[float]] = None


@dataclass(slots=True)
class DownbeatAnalysis:
    """Downbeat estimates (model-based when available, heuristic otherwise)."""

    downbeat_times: List[float]
    beat_positions: List[int]
    source: str


def _compute_confidence(beat_times: np.ndarray) -> float:
    """Grid-regularity score: 1 - std/mean of inter-beat intervals,
    clipped to [0, 1]."""

    intervals = np.diff(np.asarray(beat_times, dtype=float))
    if intervals.size == 0:
        return 0.0
    if np.allclose(intervals, intervals[0]):
        return 1.0
    spread = np.std(intervals) / (np.mean(intervals) + 1e-9)
    return float(np.clip(1.0 - spread, 0.0, 1.0))


def tracked_times_for(
    audio: AudioInput,
    env: np.ndarray,
    bpm: float,
    *,
    hop_length: int = 512,
    device="cuda",
) -> np.ndarray:
    """Drift-following tracked beats for the per-module path. The
    low-band curve comes from the downbeat decoder's accent graph, the
    curve the fused graph reads back as ``low_energy``. Empty for a
    degenerate envelope."""

    from .. import tempo
    from ..models.downbeat import _accent_curves

    _energy, low, _flux = _accent_curves(audio.samples, audio.sample_rate, device)
    return tempo.track_beats(
        env, audio.sample_rate, hop_length=hop_length, bpm=bpm, low_energy=low
    )


def analyse_beats(
    audio: AudioInput,
    *,
    hop_length: int = 512,
    seed: int,
    device="cuda",
) -> Tuple[BeatAnalysis, Optional[DownbeatAnalysis]]:
    """Estimate the beat grid and the downbeats of ``audio``: one envelope
    pass feeds both the grid and the BPM refinement."""

    seed_everything(seed)
    if not isinstance(audio, AudioInput):
        raise TypeError("analyse_beats expects an AudioInput instance")

    from .. import tempo

    env, ac = tempo._envelope_and_autocorr(
        np.asarray(audio.samples, dtype=np.float32), audio.sample_rate, hop_length, device
    )
    grid, bpm = tempo.grid_and_bpm_from_env(
        env, ac, len(audio.samples) / float(audio.sample_rate),
        audio.sample_rate, hop_length=hop_length,
    )
    tracked_times = tracked_times_for(audio, env, bpm, hop_length=hop_length, device=device)
    beat_result = build_beat_analysis(
        bpm, grid["time"], audio.sample_rate,
        hop_length=hop_length, grid=grid, tracked_times=tracked_times,
    )
    downbeat_result = analyse_downbeats(
        audio, beat_result, hop_length=hop_length, seed=seed, device=device
    )
    return beat_result, downbeat_result


def build_beat_analysis(
    bpm: float,
    beat_times: np.ndarray,
    sr: int,
    *,
    hop_length: int = 512,
    grid: Optional[Dict[str, np.ndarray]] = None,
    tracked_times: Optional[np.ndarray] = None,
) -> BeatAnalysis:
    beat_times = np.asarray(beat_times, dtype=float)
    beat_frames = np.floor(beat_times * sr / hop_length).astype(int)
    confidence = _compute_confidence(beat_times)
    return BeatAnalysis(
        bpm=float(bpm),
        beat_times=beat_times.astype(float).tolist(),
        beat_frames=beat_frames.astype(int).tolist(),
        confidence=confidence,
        grid=None if grid is None else {k: np.array(v) for k, v in grid.items()},
        tracked_times=(
            None
            if tracked_times is None or not len(tracked_times)
            else [float(t) for t in tracked_times]
        ),
    )


def analyse_downbeats(
    audio: AudioInput,
    beat_result: BeatAnalysis,
    *,
    hop_length: int = 512,
    seed: int,
    device="cuda",
) -> Optional[DownbeatAnalysis]:
    """Downbeats from the accent decoder (with the net's evidence when a
    checkpoint is bundled), on the tracked beats when there are at least
    8 of them, else on the constant grid; the every-4th-beat heuristic
    when the decoder has too few beats."""

    if not isinstance(audio, AudioInput):
        raise TypeError("analyse_downbeats expects an AudioInput instance")
    seed_everything(seed)

    from ..models import downbeat as downbeat_model

    if downbeat_model.available():
        base = (
            beat_result.tracked_times
            if beat_result.tracked_times is not None and len(beat_result.tracked_times) >= 8
            else beat_result.beat_times
        )
        tracked = downbeat_model.track_downbeats(
            audio.samples,
            audio.sample_rate,
            np.asarray(base, dtype=float),
            seed=seed,
            device=device,
        )
        if tracked is not None and len(tracked.downbeat_times):
            return DownbeatAnalysis(
                downbeat_times=[float(t) for t in tracked.downbeat_times],
                beat_positions=[int(p) for p in tracked.beat_positions],
                source=tracked.source,
            )
    return _fallback_downbeats(beat_result)


def _fallback_downbeats(beat_result: BeatAnalysis) -> DownbeatAnalysis:
    """Every-4th-beat assumption: the downbeat ladder's last rung."""

    times = np.asarray(beat_result.beat_times, dtype=float)
    positions = np.arange(times.size) % 4 + 1
    return DownbeatAnalysis(
        downbeat_times=times[positions == 1].tolist(),
        beat_positions=positions.tolist(),
        source="heuristic",
    )
