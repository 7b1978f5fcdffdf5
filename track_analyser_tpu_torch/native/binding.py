"""ctypes binding to ``libta_native``: WAV and FLAC decode and the
transport quantisers.

The library builds at first use (``native/build.py``) and loads with
``ctypes.CDLL``, which releases the GIL for the length of each call: the
sweep's decode and staging workers quantise in parallel with each other
and with the upload and finish threads. The port needs the library; a
host without a C++ compiler raises on the first call. ``decode`` and
``decode_flac`` return None where the library declines a file; the
quantisers write payloads bit for bit those of the numpy plain versions
in ``parallel/batch.py`` (their float64 stereo sums add in another order).
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, Optional, Tuple

import numpy as np

from . import build

__all__ = [
    "load",
    "decode",
    "decode_flac",
    "quantise_i8",
    "quantise_i16",
    "quantise_i16_stereo",
    "quantise_ms",
    "quantise_mid",
    "quantise_mid6",
    "quantise_mid5",
]

_F32P = ctypes.POINTER(ctypes.c_float)
_I64 = ctypes.c_longlong
_DECODE_ARGS = [
    ctypes.c_char_p,
    ctypes.POINTER(_F32P),
    ctypes.POINTER(ctypes.c_longlong),  # frames
    ctypes.POINTER(ctypes.c_int),  # channels
    ctypes.POINTER(ctypes.c_int),  # sample rate
    ctypes.POINTER(ctypes.c_int),  # subtype code (WAV) / bits per sample (FLAC)
]
_SUBBYTE_ARGS = [
    _F32P, _I64, _I64, _I64, _I64, ctypes.c_float,
    ctypes.POINTER(ctypes.c_uint8), _F32P, _F32P, ctypes.POINTER(ctypes.c_double), _F32P,
]
# symbol -> (restype, argtypes), transport.cpp / decoder.cpp / flac.cpp
_SIGNATURES = {
    "ta_decode_wav": (ctypes.c_int, _DECODE_ARGS),
    "ta_decode_flac": (ctypes.c_int, _DECODE_ARGS),
    "ta_free": (None, [_F32P]),
    "ta_quantise_i8": (None, [_F32P, _I64, _I64, _I64, _I64, ctypes.POINTER(ctypes.c_int8), _F32P]),
    "ta_quantise_i16": (None, [_F32P, _I64, _I64, ctypes.POINTER(ctypes.c_int16)]),
    "ta_quantise_i16_stereo": (None, [_F32P, _I64, _I64, _I64, ctypes.POINTER(ctypes.c_int16)]),
    "ta_quantise_ms": (
        None,
        [
            _F32P, _I64, _I64, _I64, _I64, ctypes.POINTER(ctypes.c_int8), _F32P,
            ctypes.POINTER(ctypes.c_uint8), _F32P, _F32P, ctypes.POINTER(ctypes.c_double),
        ],
    ),
    "ta_quantise_mid": (
        None,
        [_F32P, _I64, _I64, _I64, _I64, ctypes.POINTER(ctypes.c_int8), _F32P, ctypes.POINTER(ctypes.c_double)],
    ),
    "ta_quantise_mid6": (None, _SUBBYTE_ARGS),
    "ta_quantise_mid5": (None, _SUBBYTE_ARGS),
}
_WAV_SUBTYPES = {1: "PCM_16", 2: "PCM_24", 3: "PCM_32", 4: "FLOAT", 5: "DOUBLE", 6: "PCM_U8"}
_lib: "list[ctypes.CDLL]" = []
_lock = threading.Lock()


def load() -> ctypes.CDLL:
    """``libta_native``, built at the first call and loaded once per
    process with every symbol's signature declared. Raises when it
    cannot be built."""

    with _lock:
        if not _lib:
            path, _log = build.build_native()
            lib = ctypes.CDLL(str(path))
            for name, (restype, argtypes) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype = restype
                fn.argtypes = argtypes
            _lib.append(lib)
        return _lib[0]


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _decode(symbol: str, path: str):
    """(interleaved samples (frames, channels) float32, sample rate, the
    fifth output) or None when the library declines ``path``."""

    lib = load()
    buf = _F32P()
    frames, channels, sr, extra = ctypes.c_longlong(0), ctypes.c_int(0), ctypes.c_int(0), ctypes.c_int(0)
    rc = getattr(lib, symbol)(
        str(path).encode(), ctypes.byref(buf), ctypes.byref(frames), ctypes.byref(channels),
        ctypes.byref(sr), ctypes.byref(extra),
    )
    if rc != 0:
        return None
    try:
        if frames.value * channels.value == 0:
            data = np.zeros((channels.value, 0), dtype=np.float32)
        else:
            # one copy straight to channel-major: the transposed view of
            # the C buffer materialises in .copy()
            data = np.ctypeslib.as_array(buf, shape=(frames.value, channels.value)).T.copy()
    finally:
        lib.ta_free(buf)
    return data, sr.value, extra.value


def _meta(data: np.ndarray, sr: int, file_type: str, subtype: str) -> Dict[str, object]:
    return {
        "channels": int(data.shape[0]),
        "duration": data.shape[1] / float(sr) if sr else 0.0,
        "file_type": file_type,
        "subtype": subtype,
    }


def decode(path: str) -> Optional[Tuple[np.ndarray, int, Dict[str, object]]]:
    """Decode a RIFF/WAVE file (PCM 8/16/24/32, float32/64, extensible) to
    channel-major float32; None where the library declines the file."""

    out = _decode("ta_decode_wav", path)
    if out is None:
        return None
    data, sr, subtype = out
    return data, sr, _meta(data, sr, "WAV", _WAV_SUBTYPES.get(subtype, "UNKNOWN"))


def decode_flac(path: str) -> Optional[Tuple[np.ndarray, int, Dict[str, object]]]:
    """Decode a FLAC file to channel-major float32, bit for bit
    ``io/flac.decode_flac``; None where the library declines the file."""

    out = _decode("ta_decode_flac", path)
    if out is None:
        return None
    data, sr, bps = out
    return data, sr, _meta(data, sr, "FLAC", f"PCM_{bps}")


def _channels(x: np.ndarray, n_bucket: int, block: int = 1, group: int = 1) -> np.ndarray:
    """``x`` as a contiguous (1|2, n) float32 array, checked against the
    output's size: n <= n_bucket, n_bucket a multiple of ``block``,
    ``block`` of ``group`` (a pack group must not straddle a block)."""

    x = np.ascontiguousarray(x, dtype=np.float32)
    if x.ndim == 1:
        x = x[None, :]
    if x.ndim != 2 or x.shape[0] not in (1, 2):
        raise ValueError(f"expected (n,), (1, n) or (2, n) samples, got shape {x.shape}")
    if x.shape[1] > n_bucket:
        raise ValueError(f"{x.shape[1]} samples do not fit a bucket of {n_bucket}")
    if block <= 0 or n_bucket % block or block % group:
        raise ValueError(
            f"n_bucket {n_bucket} must be a multiple of block {block}, and block of {group}"
        )
    return x


def quantise_i8(x: np.ndarray, n_bucket: int, block: int) -> Tuple[np.ndarray, np.ndarray]:
    """Pad + blockwise int8 of a (1|2, n) signal, a mono one duplicated:
    (values (2, n_bucket) int8, scales (2, n_bucket / block) float32)."""

    x = _channels(x, n_bucket, block)
    vals = np.empty((2, n_bucket), dtype=np.int8)
    scales = np.empty((2, n_bucket // block), dtype=np.float32)
    load().ta_quantise_i8(_ptr(x, ctypes.c_float), x.shape[0], x.shape[1], n_bucket, block,
                          _ptr(vals, ctypes.c_int8), _ptr(scales, ctypes.c_float))
    return vals, scales


def quantise_i16(x: np.ndarray, n_bucket: int) -> np.ndarray:
    """Pad + truncating int16 (full scale 32768) of a mono signal -> (n_bucket,)."""

    x = _channels(x, n_bucket)
    if x.shape[0] != 1:
        raise ValueError("quantise_i16 takes one channel")
    out = np.empty(n_bucket, dtype=np.int16)
    load().ta_quantise_i16(_ptr(x, ctypes.c_float), x.shape[1], n_bucket, _ptr(out, ctypes.c_int16))
    return out


def quantise_i16_stereo(x: np.ndarray, n_bucket: int) -> np.ndarray:
    """Pad + truncating int16 of a (1|2, n) signal -> (2, n_bucket)."""

    x = _channels(x, n_bucket)
    out = np.empty((2, n_bucket), dtype=np.int16)
    load().ta_quantise_i16_stereo(_ptr(x, ctypes.c_float), x.shape[0], x.shape[1], n_bucket,
                                  _ptr(out, ctypes.c_int16))
    return out


def quantise_ms(
    x: np.ndarray, n_bucket: int, block: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.float32, np.ndarray]:
    """Mid as blockwise int8 and side as blockwise int4 (two codes a byte)
    with the float64 stereo sums in one pass: (mid (n_bucket,) int8, mid
    scales, side (n_bucket / 2,) uint8, side scales, the side's
    quantisation noise power, stats (8,) float64). The port's transports
    ship the mid only (``quantise_mid``); its mid, scales and stats equal
    these bit for bit."""

    x = _channels(x, n_bucket, block, 2)
    mid = np.empty(n_bucket, dtype=np.int8)
    mid_scales = np.empty(n_bucket // block, dtype=np.float32)
    side = np.empty(n_bucket // 2, dtype=np.uint8)
    side_scales = np.empty(n_bucket // block, dtype=np.float32)
    noise = np.empty(1, dtype=np.float32)
    stats = np.empty(8, dtype=np.float64)
    load().ta_quantise_ms(
        _ptr(x, ctypes.c_float), x.shape[0], x.shape[1], n_bucket, block,
        _ptr(mid, ctypes.c_int8), _ptr(mid_scales, ctypes.c_float), _ptr(side, ctypes.c_uint8),
        _ptr(side_scales, ctypes.c_float), _ptr(noise, ctypes.c_float), _ptr(stats, ctypes.c_double),
    )
    return mid, mid_scales, side, side_scales, noise[0], stats


def quantise_mid(x: np.ndarray, n_bucket: int, block: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The "ms" transport's quantiser: the padded mid (l + r) / 2 as
    blockwise int8 and the float64 stereo sums, (mid (n_bucket,) int8,
    scales (n_bucket / block,) float32, stats (8,) float64); the payload
    of ``_quantise_mid_range(x, n, 0, n_bucket)``."""

    x = _channels(x, n_bucket, block)
    mid = np.empty(n_bucket, dtype=np.int8)
    scales = np.empty(n_bucket // block, dtype=np.float32)
    stats = np.empty(8, dtype=np.float64)
    load().ta_quantise_mid(_ptr(x, ctypes.c_float), x.shape[0], x.shape[1], n_bucket, block,
                           _ptr(mid, ctypes.c_int8), _ptr(scales, ctypes.c_float), _ptr(stats, ctypes.c_double))
    return mid, scales, stats


def _quantise_subbyte(symbol: str, bits: int, x: np.ndarray, n_bucket: int, block: int, carry: float):
    group = 4 if bits == 6 else 8
    x = _channels(x, n_bucket, block, group)
    packed = np.empty(bits * n_bucket // 8, dtype=np.uint8)
    scales = np.empty(n_bucket // block, dtype=np.float32)
    bases = np.empty(n_bucket // block, dtype=np.float32)
    stats = np.empty(8, dtype=np.float64)
    carry_out = ctypes.c_float(0.0)
    getattr(load(), symbol)(
        _ptr(x, ctypes.c_float), x.shape[0], x.shape[1], n_bucket, block, ctypes.c_float(carry),
        _ptr(packed, ctypes.c_uint8), _ptr(scales, ctypes.c_float), _ptr(bases, ctypes.c_float),
        _ptr(stats, ctypes.c_double), ctypes.byref(carry_out),
    )
    return packed, scales, bases, stats, float(carry_out.value)


def quantise_mid6(
    x: np.ndarray, n_bucket: int, block: int, carry: float = 0.0
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, float]:
    """The "ms6" transport's quantiser: per block the better of raw and
    delta-with-error-feedback 6-bit codes, four packed into three bytes:
    (packed (3 n_bucket / 4,) uint8, scales (sign = mode), bases, stats
    (8,) float64, carry out); the payload of ``_quantise_mid6_range``.
    ``carry`` is the sample entering the first block."""

    return _quantise_subbyte("ta_quantise_mid6", 6, x, n_bucket, block, carry)


def quantise_mid5(
    x: np.ndarray, n_bucket: int, block: int, carry: float = 0.0
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, float]:
    """The "ms5" transport's quantiser: noise-shaped 5-bit codes, eight
    packed into five bytes; otherwise as :func:`quantise_mid6`."""

    return _quantise_subbyte("ta_quantise_mid5", 5, x, n_bucket, block, carry)
