"""Out-of-family accuracy: the port held to the repo's independent-engine gates.

The songs come from ``scripts/independent_engine.py``, a rendering engine
that shares no code with the generators any of the repo's models trained
on (wavetable oscillators, linear ADSR envelopes, biquad-resonator drums,
formant-filtered pulse vocals, Schroeder reverb). Callers render the songs
and pass the arrays in; this module renders nothing and imports nothing
of the training code, so a score measured here is evidence about
generalisation, not memorisation.

``evaluate_song`` runs the fused analysis (``parallel.batch.analyse_track_fused``)
and the DSP separator (``analysis.stems.separate_stems_arrays``) on one
song and scores them: tracked-beat and downbeat F1 within +-70 ms, and
per stem the SI-SDR gain of the separated stem over the mixture.
``check_gates`` holds a set of rows to ``SINGLE_SONG_GATES`` or
``DISTRIBUTION_GATES``, the floors of ``tests/test_independent_eval.py``.
The metrics are those of ``scripts/eval_independent.py`` and
``scripts/eval_independent_dist.py``, in numpy float64.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .analysis.stems import separate_stems_arrays
from .parallel.batch import analyse_track_fused
from .pipeline import TrackAnalysisResult
from .utils import AudioInput

__all__ = [
    "STEMS",
    "F1_TOL",
    "Gate",
    "SongEval",
    "SINGLE_SONG_GATES",
    "DISTRIBUTION_GATES",
    "f1_within",
    "si_sdr",
    "evaluate_song",
    "check_gates",
]

STEMS = ("drums", "bass", "other", "vocals")
F1_TOL = 0.070  # s, the hit window of scripts/eval_independent.py and tests/test_independent_eval.py
_SILENT = 1e-9  # |ref|^2 under which a stem is silent (a draw without vocals) and not scored


def f1_within(pred: np.ndarray, truth: np.ndarray) -> float:
    """F1 of predicted against true event times (s): a prediction is a hit
    when a true time lies within ``F1_TOL`` of it, and a true time is found
    when a prediction does. 0 when either side is empty or nothing hits."""

    pred = np.asarray(pred, dtype=np.float64)
    truth = np.asarray(truth, dtype=np.float64)
    if pred.size == 0 or truth.size == 0:
        return 0.0
    dist = np.abs(pred[:, None] - truth[None, :])
    precision = (dist.min(axis=1) <= F1_TOL).sum() / pred.size
    recall = (dist.min(axis=0) <= F1_TOL).sum() / truth.size
    return 0.0 if precision + recall == 0 else float(2 * precision * recall / (precision + recall))


def si_sdr(est: np.ndarray, ref: np.ndarray) -> float:
    """Scale-invariant signal-to-distortion ratio (dB) of ``est`` against
    ``ref``, both mean-removed, in float64."""

    ref = np.asarray(ref, dtype=np.float64)
    est = np.asarray(est, dtype=np.float64)
    ref = ref - ref.mean()
    est = est - est.mean()
    denom = float(np.dot(ref, ref)) + 1e-12
    proj = (float(np.dot(est, ref)) / denom) * ref
    noise = est - proj
    return float(10.0 * np.log10((np.dot(proj, proj) + 1e-12) / (np.dot(noise, noise) + 1e-12)))


@dataclass
class SongEval:
    """One song's row: what the analysis decided, its scores, and the walls."""

    meter: Optional[int]  # the song's meter, as rendered (None: not given)
    bpm: float
    decoded_meter: int  # the largest bar position the downbeat decoder gave (0: none)
    downbeat_source: Optional[str]
    beat_f1: float  # tracked beats against the true beats
    downbeat_f1: float  # downbeats against the true bar starts
    delta_si_sdr: Dict[str, float] = field(default_factory=dict)  # per stem, silent stems left out
    result: Optional[TrackAnalysisResult] = None
    analysis_s: float = 0.0
    separation_s: float = 0.0


@dataclass(frozen=True)
class Gate:
    """A floor on a statistic ("min" or "median") of one metric over the
    rows, optionally only over the rows of one meter, which must then
    number at least ``min_rows``. ``metric`` is "beat_f1", "downbeat_f1"
    or a stem name (its ΔSI-SDR, dB)."""

    metric: str
    stat: str
    floor: float
    meter: Optional[int] = None
    min_rows: int = 1

    @property
    def name(self) -> str:
        what = f"ΔSI-SDR {self.metric}" if self.metric in STEMS else self.metric
        where = f" (meter {self.meter} rows)" if self.meter is not None else ""
        return f"{what} {self.stat}{where} >= {self.floor}"


# tests/test_independent_eval.py:69-110, the fixed song (render_song):
# tracked beats (:69-72), downbeats (:75-84) and the separation floors (:104).
SINGLE_SONG_GATES = (
    Gate("beat_f1", "min", 0.90),
    Gate("downbeat_f1", "min", 0.80),
    Gate("drums", "min", 8.0),
    Gate("bass", "min", 1.5),
    Gate("other", "min", 1.5),
    Gate("vocals", "min", 5.0),
)

# tests/test_independent_eval.py:143-200, the twelve randomised songs:
# tracked beats (:152-153), downbeats (:168-169), the 3/4 subset (:172-175)
# and the separation medians (:196).
DISTRIBUTION_GATES = (
    Gate("beat_f1", "median", 0.95),
    Gate("beat_f1", "min", 0.85),
    Gate("downbeat_f1", "median", 0.85),
    Gate("downbeat_f1", "min", 0.70),
    Gate("downbeat_f1", "median", 0.90, meter=3, min_rows=4),
    Gate("drums", "median", 8.0),
    Gate("bass", "median", 2.0),
    Gate("other", "median", 0.0),
    Gate("vocals", "median", 3.0),
)


def evaluate_song(
    stems: Dict[str, np.ndarray],
    mix: np.ndarray,
    beat_times: np.ndarray,
    bar_starts: np.ndarray,
    *,
    sample_rate: int,
    meter: Optional[int] = None,
    device: "str | torch.device" = "cuda",
    separate: bool = True,
) -> SongEval:
    """Analyse and separate one rendered mono song on ``device`` and score
    it against its ground truth (``stems``, ``beat_times``, ``bar_starts``,
    in seconds). ``meter`` is the song's meter, kept for the gates of one
    meter. ``separate=False`` skips the separator (no ΔSI-SDR)."""

    mix = np.asarray(mix, dtype=np.float32)
    t0 = time.perf_counter()
    result = analyse_track_fused(AudioInput(samples=mix, sample_rate=sample_rate), device=device)
    analysis_s = time.perf_counter() - t0
    tracked = np.asarray(result.beat.tracked_times or [])
    downbeats = np.asarray(result.downbeat.downbeat_times if result.downbeat else [])
    positions = result.downbeat.beat_positions if result.downbeat else []
    row = SongEval(
        meter=meter,
        bpm=float(result.beat.bpm),
        decoded_meter=int(max(positions)) if positions else 0,
        downbeat_source=result.downbeat.source if result.downbeat else None,
        beat_f1=f1_within(tracked, beat_times),
        downbeat_f1=f1_within(downbeats, bar_starts),
        result=result,
        analysis_s=analysis_s,
    )
    if separate:
        t0 = time.perf_counter()
        est = separate_stems_arrays(mix, sample_rate, device=device)
        row.separation_s = time.perf_counter() - t0
        for name in STEMS:
            ref = np.asarray(stems[name], dtype=np.float64)
            if float(np.dot(ref, ref)) < _SILENT:
                continue
            row.delta_si_sdr[name] = si_sdr(est[name], ref) - si_sdr(mix, ref)
    return row


def _values(rows: Sequence[SongEval], gate: Gate) -> np.ndarray:
    if gate.meter is not None:
        rows = [r for r in rows if r.meter == gate.meter]
    if gate.metric in STEMS:
        return np.array([r.delta_si_sdr[gate.metric] for r in rows if gate.metric in r.delta_si_sdr])
    return np.array([getattr(r, gate.metric) for r in rows])


def check_gates(rows: Sequence[SongEval], gates: Sequence[Gate] = DISTRIBUTION_GATES) -> List[str]:
    """The gates that ``rows`` fail, one string each naming the gate and
    the values it read; an empty list when every gate holds."""

    failures = []
    for gate in gates:
        values = _values(rows, gate)
        if values.size < gate.min_rows:
            failures.append(f"{gate.name}: {values.size} rows, at least {gate.min_rows} needed")
            continue
        stat = float(np.median(values) if gate.stat == "median" else values.min())
        if not stat >= gate.floor:
            failures.append(f"{gate.name}: {gate.stat} {stat:.4f} from {np.round(values, 3).tolist()}")
    return failures
