"""Spectral summary feature results (LTAS, centroid, roll-off)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np

__all__ = ["LongTermAverageSpectrum", "FeatureSeries", "FeatureAnalysis"]


@dataclass(slots=True)
class LongTermAverageSpectrum:
    """Long-term average spectrum (LTAS) of a signal."""

    frequencies: np.ndarray
    magnitude: np.ndarray

    def as_dict(self) -> dict[str, Sequence[float]]:
        return {
            "frequencies": self.frequencies.tolist(),
            "magnitude": self.magnitude.tolist(),
        }


@dataclass(slots=True)
class FeatureSeries:
    """Container for frame-wise spectral features."""

    values: np.ndarray

    @property
    def mean(self) -> float:
        return float(np.mean(self.values)) if self.values.size else 0.0

    @property
    def median(self) -> float:
        return float(np.median(self.values)) if self.values.size else 0.0

    @property
    def as_list(self) -> list[float]:
        return self.values.tolist()


@dataclass(slots=True)
class FeatureAnalysis:
    """Aggregates the spectral feature outputs."""

    ltas: LongTermAverageSpectrum
    spectral_centroid: FeatureSeries
    spectral_rolloff: FeatureSeries
