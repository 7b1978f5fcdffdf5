"""Deprecated shim re-exporting the harmony symbols.

Attributes are resolved lazily, so this shim never takes part in the
harmony <-> analysis import cycle.
"""

from __future__ import annotations

import warnings

__all__ = [
    "HarmonyAnalysis",
    "ChordChangePoint",
    "ChordHint",
    "KeyEstimation",
    "KeyEstimate",
    "MidiSuggestion",
    "SpectralBalance",
    "StereoImage",
    "analyse_harmonic",
    "key_estimate",
]

_FORWARDED = {
    "HarmonyAnalysis",
    "ChordChangePoint",
    "ChordHint",
    "KeyEstimation",
    "KeyEstimate",
    "MidiSuggestion",
    "SpectralBalance",
    "StereoImage",
    "key_estimate",
    "analyse_harmony",
}


def __getattr__(name: str):
    if name in _FORWARDED:
        from .. import harmony

        return getattr(harmony, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def analyse_harmonic(*args, **kwargs):
    """Deprecated alias for :func:`track_analyser_tpu_torch.harmony.analyse_harmony`."""

    from .. import harmony

    warnings.warn(
        "analyse_harmonic is deprecated; use track_analyser_tpu_torch.harmony.analyse_harmony",
        DeprecationWarning,
        stacklevel=2,
    )
    return harmony.analyse_harmony(*args, **kwargs)
