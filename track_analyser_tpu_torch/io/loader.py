"""Host-side audio loading (decode + resample).

The JAX package's loader contract: channel-major float32 samples, sample
rate, and a metadata dict with channels / duration / file_type
(/ subtype).
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np

from ..ops.resample import resample_poly_host
from .codecs import decode_file

__all__ = ["load_audio"]


def load_audio(
    path: "str | Path",
    target_sr: Optional[int] = None,
    mono: bool = True,
) -> Tuple[np.ndarray, int, Dict[str, object]]:
    """Load ``path`` into memory and return samples, sample rate, metadata:
    decode, optionally resample, optionally downmix to mono. The metadata
    reports the *original* channel count and the duration after
    resampling."""

    file_path = str(path)
    data, sr, meta = decode_file(file_path)

    if data.ndim == 1:
        data = data[np.newaxis, :]

    original_channels = int(data.shape[0])

    if target_sr is not None and sr != target_sr:
        data = resample_poly_host(data, sr, target_sr)
        sr = target_sr

    if mono and data.shape[0] > 1:
        data = np.mean(data, axis=0, keepdims=True)

    meta["channels"] = original_channels
    meta["duration"] = data.shape[-1] / float(sr)
    meta["file_type"] = (
        meta.get("file_type") or Path(file_path).suffix.lstrip(".").upper() or "UNKNOWN"
    )

    if mono:
        return data.squeeze(axis=0), sr, meta
    return data, sr, meta
