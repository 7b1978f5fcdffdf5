"""Analysis results and host finishers (beats, structure, loudness),
and stem separation."""

from . import beats, loudness, stems, structure

__all__ = ["beats", "loudness", "stems", "structure"]
