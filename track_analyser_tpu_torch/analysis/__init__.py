"""Analysis modules (beats, structure, loudness, stems, harmonic shim)."""

from . import beats, loudness, stems, structure
from . import harmonic  # imported last: re-exports from ..harmony, which needs .beats

__all__ = ["beats", "harmonic", "loudness", "stems", "structure"]
