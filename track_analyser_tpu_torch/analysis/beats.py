"""Beat and downbeat results (host, numpy).

The ``BeatAnalysis`` / ``DownbeatAnalysis`` dataclasses of the JAX
package, the inter-beat-interval confidence formula, and the
every-4th-beat fallback for downbeats.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

__all__ = [
    "BeatAnalysis",
    "DownbeatAnalysis",
    "build_beat_analysis",
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


def _fallback_downbeats(beat_result: BeatAnalysis) -> DownbeatAnalysis:
    """Every-4th-beat assumption: the downbeat ladder's last rung."""

    times = np.asarray(beat_result.beat_times, dtype=float)
    positions = np.arange(times.size) % 4 + 1
    return DownbeatAnalysis(
        downbeat_times=times[positions == 1].tolist(),
        beat_positions=positions.tolist(),
        source="heuristic",
    )
