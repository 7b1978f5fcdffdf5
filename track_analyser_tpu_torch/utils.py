"""Core types and deterministic seeding helpers.

``AudioInput`` (mono float32 ``samples`` plus optional channel-major
stereo ``(2, n)``), ``coerce_audio``, ``deterministic_rng`` and
``seed_everything``, with the JAX package's semantics.
"""

from __future__ import annotations

import random
from dataclasses import dataclass
from pathlib import Path
from typing import Iterable, Optional, Sequence

import numpy as np

from .config import DEFAULT_SEED, DEFAULT_SR
from .io.codecs import decode_file
from .native import binding
from .ops.resample import resample_poly_host
from .profiling import span

__all__ = [
    "AudioInput",
    "coerce_audio",
    "deterministic_rng",
    "seed_everything",
    "DEFAULT_SR",
    "DEFAULT_SEED",
]


@dataclass(slots=True)
class AudioInput:
    """Audio payload: mono float32 samples plus optional stereo channels."""

    samples: np.ndarray
    sample_rate: int
    path: Optional[str] = None
    stereo_samples: Optional[np.ndarray] = None

    @property
    def duration(self) -> float:
        return float(len(self.samples)) / float(self.sample_rate)


def deterministic_rng(seed: int = DEFAULT_SEED) -> np.random.Generator:
    """Return a numpy Generator seeded deterministically."""

    return np.random.default_rng(seed)


def seed_everything(seed: int = DEFAULT_SEED) -> None:
    """Seed the global host RNGs (numpy, random) for deterministic behaviour."""

    np.random.seed(seed)
    random.seed(seed)


def _resample(samples: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    if orig_sr == target_sr:
        return samples
    return resample_poly_host(samples, orig_sr, target_sr)


def _unpack_source(
    source, mono: bool, target_sr: int
) -> tuple[np.ndarray, Optional[np.ndarray], Optional[int], Optional[str]]:
    """Normalise any accepted source into (mono, stereo|None, sr|None, path).

    ``sr=None`` means "already at the caller's nominal rate" (raw arrays
    carry no rate of their own). A WAV at ``target_sr`` gets its mono from
    the native decode's own pass, bit for bit ``data.mean(axis=0)``.
    """

    if isinstance(source, AudioInput):
        stereo = (
            np.asarray(source.stereo_samples, dtype=np.float32)
            if source.stereo_samples is not None
            else None
        )
        return (
            np.asarray(source.samples, dtype=np.float32),
            stereo,
            source.sample_rate,
            source.path,
        )

    if isinstance(source, (str, Path)):
        path = str(source)
        # the native WAV pass first, as in decode_file's ladder, for its mono
        native = binding.decode_with_mono(path, target_sr)
        if native is None:
            data, sr, _meta = decode_file(path)  # channel-major (channels, frames)
            downmix = None
        else:
            data, sr, _meta, downmix = native
        return (data.mean(axis=0) if downmix is None else downmix), data, sr, path

    if isinstance(source, np.ndarray) or (isinstance(source, tuple) and len(source) == 2):
        if isinstance(source, tuple):
            data, sr = source
            arr = np.asarray(list(data), dtype=np.float32)
            rate: Optional[int] = int(sr)
        else:
            arr, rate = np.asarray(source, dtype=np.float32), None
        if arr.ndim > 1:
            # mono=False keeps the raw layout in .samples
            return (arr.mean(axis=0) if mono else arr, arr, rate, None)
        return arr, None, rate, None

    raise TypeError(f"Unsupported audio source type: {type(source)!r}")


def coerce_audio(
    source: "str | Path | Sequence[float] | np.ndarray | AudioInput | tuple[Iterable[float], int]",
    *,
    target_sr: int = DEFAULT_SR,
    mono: bool = True,
) -> AudioInput:
    """Normalise ``source`` into an :class:`AudioInput` at ``target_sr``.

    Accepts a path, a numpy array, an ``(iterable, sr)`` tuple, or an
    existing :class:`AudioInput`.
    """

    mono_samples, stereo, sr, path = _unpack_source(source, mono, target_sr)
    if sr is not None and sr != target_sr:
        with span("resample"):
            if stereo is not None:
                stereo = _resample(stereo, sr, target_sr)
                mono_samples = stereo.mean(axis=0) if mono else _resample(mono_samples, sr, target_sr)
            else:
                mono_samples = _resample(mono_samples, sr, target_sr)
    return AudioInput(
        samples=np.asarray(mono_samples, dtype=np.float32),
        sample_rate=target_sr,
        path=path,
        stereo_samples=stereo,
    )
