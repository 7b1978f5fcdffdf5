"""Loudness result (EBU R128 integrated loudness, curves, range, peaks)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

__all__ = ["LoudnessAnalysis"]


@dataclass(slots=True)
class LoudnessAnalysis:
    integrated_lufs: float
    short_term_lufs: List[float]
    momentary_lufs: List[float]
    loudness_range: float
    true_peak_dbfs: float
    rms_dbfs: float
