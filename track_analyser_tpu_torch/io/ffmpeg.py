"""The decode ladder's catch-all tier: ``native/src/ffmpeg.cpp`` over the
system libavformat / libavcodec (M4A, AAC, WMA, anything they decode),
bound with ctypes.

The library builds at first use where the libav* headers and libraries
are present; ``unavailable_reason()`` says why the tier is absent
otherwise. With both present, a failed build raises.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np

from ..native import build

__all__ = ["available", "unavailable_reason", "decode"]

_F32P = ctypes.POINTER(ctypes.c_float)
_lib: "list[ctypes.CDLL]" = []
_lock = threading.Lock()


def unavailable_reason() -> Optional[str]:
    """Why the tier is absent here, or None when it is present."""

    return build.ffmpeg_absent_reason()


def available() -> bool:
    return unavailable_reason() is None


def _load() -> ctypes.CDLL:
    with _lock:
        if not _lib:
            path, _log = build.build_ffmpeg()
            lib = ctypes.CDLL(str(path))
            lib.ta_ffmpeg_decode.restype = ctypes.c_int
            lib.ta_ffmpeg_decode.argtypes = [
                ctypes.c_char_p,
                ctypes.POINTER(_F32P),
                ctypes.POINTER(ctypes.c_longlong),  # frames
                ctypes.POINTER(ctypes.c_int),  # channels
                ctypes.POINTER(ctypes.c_int),  # sample rate
                ctypes.c_char_p,  # codec name out
                ctypes.c_int,
            ]
            lib.ta_ffmpeg_free.restype = None
            lib.ta_ffmpeg_free.argtypes = [_F32P]
            _lib.append(lib)
        return _lib[0]


def decode(path: str) -> Optional[Tuple[np.ndarray, int, Dict[str, object]]]:
    """Decode any file libavformat can open to channel-major float32 at
    the stream's own rate; None where it declines. Call only where
    :func:`available` is True."""

    lib = _load()
    buf = _F32P()
    frames, channels, sr = ctypes.c_longlong(0), ctypes.c_int(0), ctypes.c_int(0)
    codec = ctypes.create_string_buffer(32)
    rc = lib.ta_ffmpeg_decode(
        str(path).encode(), ctypes.byref(buf), ctypes.byref(frames), ctypes.byref(channels),
        ctypes.byref(sr), codec, ctypes.c_int(len(codec)),
    )
    if rc != 0:
        return None
    try:
        if frames.value * channels.value == 0:
            data = np.zeros((channels.value, 0), dtype=np.float32)
        else:
            data = np.ctypeslib.as_array(buf, shape=(frames.value, channels.value)).T.copy()
    finally:
        lib.ta_ffmpeg_free(buf)
    codec_name = codec.value.decode(errors="replace").upper()
    meta: Dict[str, object] = {
        "channels": channels.value,
        "duration": frames.value / float(sr.value) if sr.value else 0.0,
        "file_type": codec_name or Path(str(path)).suffix.lstrip(".").upper(),
        "subtype": "FLOAT",
    }
    return data, sr.value, meta
