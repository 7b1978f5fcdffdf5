"""MPEG audio (MP3/MP2) decode through the system libmpg123 (ctypes).

The tier is absent where ``ctypes.util.find_library`` finds no
libmpg123. ``mpg123_init`` runs once per process, when the library is
first loaded. A file the library cannot open or read raises
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

__all__ = ["available", "unavailable_reason", "decode_mp3"]

_MPG123_OK = 0
_MPG123_DONE = -12
_MPG123_NEW_FORMAT = -11
_ENC_FLOAT_32 = 0x200

_lib: "list[ctypes.CDLL]" = []
_lock = threading.Lock()


def _library_name() -> Optional[str]:
    return ctypes.util.find_library("mpg123")


def unavailable_reason() -> Optional[str]:
    """Why the tier is absent here, or None when it is present."""

    return None if _library_name() else "no system libmpg123"


def available() -> bool:
    return unavailable_reason() is None


def _load() -> ctypes.CDLL:
    with _lock:
        if not _lib:
            name = _library_name()
            if name is None:
                raise RuntimeError("libmpg123 is not installed")
            lib = ctypes.CDLL(name)
            lib.mpg123_init.restype = ctypes.c_int
            lib.mpg123_init.argtypes = []
            lib.mpg123_new.restype = ctypes.c_void_p
            lib.mpg123_new.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int)]
            lib.mpg123_open.restype = ctypes.c_int
            lib.mpg123_open.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
            lib.mpg123_getformat.restype = ctypes.c_int
            lib.mpg123_getformat.argtypes = [
                ctypes.c_void_p,
                ctypes.POINTER(ctypes.c_long),
                ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_int),
            ]
            lib.mpg123_format_none.restype = ctypes.c_int
            lib.mpg123_format_none.argtypes = [ctypes.c_void_p]
            lib.mpg123_format.restype = ctypes.c_int
            lib.mpg123_format.argtypes = [ctypes.c_void_p, ctypes.c_long, ctypes.c_int, ctypes.c_int]
            lib.mpg123_read.restype = ctypes.c_int
            lib.mpg123_read.argtypes = [
                ctypes.c_void_p,
                ctypes.c_char_p,
                ctypes.c_size_t,
                ctypes.POINTER(ctypes.c_size_t),
            ]
            lib.mpg123_close.restype = ctypes.c_int
            lib.mpg123_close.argtypes = [ctypes.c_void_p]
            lib.mpg123_delete.restype = None
            lib.mpg123_delete.argtypes = [ctypes.c_void_p]
            if lib.mpg123_init() != _MPG123_OK:
                raise RuntimeError("mpg123_init failed")
            _lib.append(lib)
        return _lib[0]


def decode_mp3(path: "str | Path") -> Tuple[np.ndarray, int, Dict[str, object]]:
    """Decode an MPEG audio file to channel-major float32."""

    lib = _load()
    err = ctypes.c_int(0)
    handle = lib.mpg123_new(None, ctypes.byref(err))
    if not handle:
        raise RuntimeError(f"mpg123_new failed ({err.value})")
    try:
        if lib.mpg123_open(handle, str(path).encode()) != _MPG123_OK:
            raise AudioDecodeError(f"mpg123 could not open {path}")
        rate, channels, encoding = ctypes.c_long(0), ctypes.c_int(0), ctypes.c_int(0)
        if lib.mpg123_getformat(handle, ctypes.byref(rate), ctypes.byref(channels), ctypes.byref(encoding)) != _MPG123_OK:
            raise AudioDecodeError(f"mpg123 could not read the format of {path}")

        # Lock the output to float32 at the stream's own rate and channels,
        # and reopen so the format holds from the first frame.
        lib.mpg123_format_none(handle)
        lib.mpg123_format(handle, rate.value, channels.value, _ENC_FLOAT_32)
        lib.mpg123_close(handle)
        if lib.mpg123_open(handle, str(path).encode()) != _MPG123_OK:
            raise AudioDecodeError(f"mpg123 could not reopen {path}")

        buf_size = 1 << 18
        buf = ctypes.create_string_buffer(buf_size)
        done = ctypes.c_size_t(0)
        chunks = []
        while True:
            rc = lib.mpg123_read(handle, buf, buf_size, ctypes.byref(done))
            if done.value:
                chunks.append(np.frombuffer(buf.raw[: done.value], dtype=np.float32).copy())
            if rc == _MPG123_DONE:
                break
            if rc == _MPG123_NEW_FORMAT:
                # The deinterleave below assumes one rate and channel
                # layout throughout.
                new_rate, new_ch, new_enc = ctypes.c_long(0), ctypes.c_int(0), ctypes.c_int(0)
                lib.mpg123_getformat(handle, ctypes.byref(new_rate), ctypes.byref(new_ch), ctypes.byref(new_enc))
                if new_rate.value != rate.value or new_ch.value != channels.value:
                    raise AudioDecodeError(f"mpg123 stream changes format mid-file: {path}")
                continue
            if rc != _MPG123_OK:
                if chunks:
                    break  # a truncated file: keep what decoded
                raise AudioDecodeError(f"mpg123 read error {rc} for {path}")

        ch = max(1, channels.value)
        flat = np.concatenate(chunks) if chunks else np.zeros(0, dtype=np.float32)
        frames = flat.size // ch
        data = np.ascontiguousarray(flat[: frames * ch].reshape(frames, ch).T)
        meta: Dict[str, object] = {
            "channels": ch,
            "duration": frames / float(rate.value) if rate.value else 0.0,
            "file_type": "MP3",
            "subtype": "MPEG_LAYER_III",
        }
        return data, int(rate.value), meta
    finally:
        lib.mpg123_close(handle)
        lib.mpg123_delete(handle)
