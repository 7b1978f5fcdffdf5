"""Ogg Vorbis decode through the system libvorbisfile (ctypes).

The tier is absent where ``ctypes.util.find_library`` finds no
libvorbisfile; a file the library cannot open or read raises
``AudioDecodeError``, on which the decode ladder steps down.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import threading
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np

from .codecs import AudioDecodeError

__all__ = ["available", "unavailable_reason", "decode_ogg"]

_lib: "list[ctypes.CDLL]" = []
_lock = threading.Lock()


class _OggVorbisFile(ctypes.Structure):
    # Generously sized; c_double units give the 8-byte alignment the real
    # OggVorbis_File (pointers, int64 offsets) needs: a byte blob is
    # 1-aligned and corrupts on unlucky (ASLR-dependent) placements.
    _fields_ = [("_opaque", ctypes.c_double * 1024)]


class _VorbisInfo(ctypes.Structure):
    _fields_ = [
        ("version", ctypes.c_int),
        ("channels", ctypes.c_int),
        ("rate", ctypes.c_long),
    ]


def _library_name() -> Optional[str]:
    return ctypes.util.find_library("vorbisfile")


def unavailable_reason() -> Optional[str]:
    """Why the tier is absent here, or None when it is present."""

    return None if _library_name() else "no system libvorbisfile"


def available() -> bool:
    return unavailable_reason() is None


def _load() -> ctypes.CDLL:
    with _lock:
        if not _lib:
            name = _library_name()
            if name is None:
                raise RuntimeError("libvorbisfile is not installed")
            lib = ctypes.CDLL(name)
            lib.ov_fopen.restype = ctypes.c_int
            lib.ov_fopen.argtypes = [ctypes.c_char_p, ctypes.POINTER(_OggVorbisFile)]
            lib.ov_info.restype = ctypes.POINTER(_VorbisInfo)
            lib.ov_info.argtypes = [ctypes.POINTER(_OggVorbisFile), ctypes.c_int]
            lib.ov_read_float.restype = ctypes.c_long
            lib.ov_read_float.argtypes = [
                ctypes.POINTER(_OggVorbisFile),
                ctypes.POINTER(ctypes.POINTER(ctypes.POINTER(ctypes.c_float))),
                ctypes.c_int,
                ctypes.POINTER(ctypes.c_int),
            ]
            lib.ov_clear.restype = ctypes.c_int
            lib.ov_clear.argtypes = [ctypes.POINTER(_OggVorbisFile)]
            _lib.append(lib)
        return _lib[0]


def decode_ogg(path: "str | Path") -> Tuple[np.ndarray, int, Dict[str, object]]:
    """Decode an Ogg Vorbis file to channel-major float32."""

    lib = _load()
    vf = _OggVorbisFile()
    if lib.ov_fopen(str(path).encode(), ctypes.byref(vf)) != 0:
        raise AudioDecodeError(f"vorbisfile could not open {path}")
    try:
        info = lib.ov_info(ctypes.byref(vf), -1).contents
        channels, rate = int(info.channels), int(info.rate)
        pcm = ctypes.POINTER(ctypes.POINTER(ctypes.c_float))()
        section = ctypes.c_int(0)
        last_section = 0
        per_channel: "list[list[np.ndarray]]" = [[] for _ in range(channels)]
        while True:
            got = lib.ov_read_float(ctypes.byref(vf), ctypes.byref(pcm), 4096, ctypes.byref(section))
            if got <= 0:
                break
            if section.value != last_section:
                # A chained stream: a new section's channel count or rate
                # would make the pcm[c] reads below invalid.
                last_section = section.value
                sec_info = lib.ov_info(ctypes.byref(vf), section.value).contents
                if int(sec_info.channels) != channels or int(sec_info.rate) != rate:
                    raise AudioDecodeError(f"chained Ogg stream changes format mid-file: {path}")
            for c in range(channels):
                per_channel[c].append(np.ctypeslib.as_array(pcm[c], shape=(got,)).copy())
        data = np.stack(
            [np.concatenate(chunks) if chunks else np.zeros(0, dtype=np.float32) for chunks in per_channel]
        ).astype(np.float32)
        meta: Dict[str, object] = {
            "channels": channels,
            "duration": data.shape[-1] / float(rate) if rate else 0.0,
            "file_type": "OGG",
            "subtype": "VORBIS",
        }
        return data, rate, meta
    finally:
        lib.ov_clear(ctypes.byref(vf))
