"""Analysis results and host finishers (beats, structure, loudness)."""

from . import beats, loudness, structure

__all__ = ["beats", "loudness", "structure"]
