"""Stereo image results (mid/side RMS, correlation, per-band width)."""

from __future__ import annotations

from dataclasses import dataclass

__all__ = ["StereoWidthBands", "StereoAnalysis"]


@dataclass(slots=True)
class StereoWidthBands:
    """Frequency dependent stereo width estimates."""

    low: float
    mid: float
    high: float

    def as_dict(self) -> dict[str, float]:
        return {"low": self.low, "mid": self.mid, "high": self.high}


@dataclass(slots=True)
class StereoAnalysis:
    """Aggregate container for stereo image metrics."""

    mid_rms: float
    side_rms: float
    correlation: float
    width: StereoWidthBands
