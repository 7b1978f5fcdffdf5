"""ctypes binding to ``libta_native``: WAV and FLAC decode and the
transport quantisers.

The library builds at first use (``native/build.py``) and loads with
``ctypes.CDLL``, which releases the GIL for the length of each call: the
sweep's decode and staging workers quantise in parallel with each other
and with the upload and finish threads. The port needs the library; a
host without a C++ compiler raises on the first call. ``decode`` and
``decode_flac`` return None where the library declines a file. ``decode``
reads a WAV's header first, allocates the channel-major planes with
numpy, and fills them in one native pass; ``decode_with_mono`` writes the
mono downmix in the same pass. The quantisers write payloads bit for bit those of the numpy plain
versions in ``parallel/batch.py`` (their float64 stereo sums add in
another order).
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, Optional, Tuple

import numpy as np

from ..profiling import span
from . import build

__all__ = [
    "load",
    "available",
    "has_transport",
    "decode",
    "decode_with_mono",
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
_INTP = ctypes.POINTER(ctypes.c_int)
_FLAC_ARGS = [
    ctypes.c_char_p,
    ctypes.POINTER(_F32P),
    ctypes.POINTER(ctypes.c_longlong),  # frames
    _INTP,  # channels
    _INTP,  # sample rate
    _INTP,  # bits per sample
]
# path, frames, channels, sample rate, subtype code, data chunk offset
_WAV_INFO_ARGS = [ctypes.c_char_p, ctypes.POINTER(_I64), _INTP, _INTP, _INTP, ctypes.POINTER(_I64)]
# path, data chunk offset, frames, channels, subtype code, planes, mono (or NULL)
_WAV_READ_ARGS = [ctypes.c_char_p, _I64, _I64, ctypes.c_int, ctypes.c_int, _F32P, _F32P]
_SUBBYTE_ARGS = [
    _F32P, _I64, _I64, _I64, _I64, ctypes.c_float,
    ctypes.POINTER(ctypes.c_uint8), _F32P, _F32P, ctypes.POINTER(ctypes.c_double), _F32P,
]
# symbol -> (restype, argtypes), transport.cpp / decoder.cpp / flac.cpp
_SIGNATURES = {
    "ta_wav_info": (ctypes.c_int, _WAV_INFO_ARGS),
    "ta_wav_read": (ctypes.c_int, _WAV_READ_ARGS),
    "ta_decode_flac": (ctypes.c_int, _FLAC_ARGS),
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


def available() -> bool:
    """True once ``libta_native`` is built and loaded. The port needs the
    library, so where it cannot be built this raises with the compiler's
    log instead of returning False (the reference falls back to numpy)."""

    load()
    return True


def has_transport() -> bool:
    """True once the library is loaded: ``load`` binds every
    ``ta_quantise_*`` symbol, so the port's library always carries the
    transport quantisers. Raises as :func:`available` does."""

    load()
    return True


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _meta(data: np.ndarray, sr: int, file_type: str, subtype: str) -> Dict[str, object]:
    return {
        "channels": int(data.shape[0]),
        "duration": data.shape[1] / float(sr) if sr else 0.0,
        "file_type": file_type,
        "subtype": subtype,
    }


def decode(path: str) -> Optional[Tuple[np.ndarray, int, Dict[str, object]]]:
    """Decode a RIFF/WAVE file (PCM 8/16/24/32, float32/64, extensible) to
    (channel-major float32 (channels, frames), sample rate, metadata);
    None where the library declines the file. The header is read first;
    one native pass then writes the planes into an array allocated here."""

    out = decode_with_mono(path, None)
    return None if out is None else out[:3]


def decode_with_mono(
    path: str, mono_rate: Optional[int]
) -> Optional[Tuple[np.ndarray, int, Dict[str, object], Optional[np.ndarray]]]:
    """``decode`` and a fourth item: where the file's rate equals
    ``mono_rate``, the mono downmix (frames,) float32 written in the same
    pass as the planes, bit for bit ``planes.mean(axis=0)``; else None (a
    resample comes first, and the downmix after it)."""

    lib = load()
    encoded = str(path).encode()
    frames, channels, sr, subtype, offset = (
        ctypes.c_longlong(0), ctypes.c_int(0), ctypes.c_int(0), ctypes.c_int(0), ctypes.c_longlong(0)
    )
    rc = lib.ta_wav_info(encoded, ctypes.byref(frames), ctypes.byref(channels), ctypes.byref(sr),
                         ctypes.byref(subtype), ctypes.byref(offset))
    if rc != 0:
        return None
    with span("decode.wav"):
        planes = np.empty((channels.value, frames.value), dtype=np.float32)
        mono = np.empty(frames.value, dtype=np.float32) if sr.value == mono_rate else None
        rc = lib.ta_wav_read(encoded, offset.value, frames.value, channels.value, subtype.value,
                             _ptr(planes, ctypes.c_float), None if mono is None else _ptr(mono, ctypes.c_float))
    if rc != 0:
        return None
    return planes, sr.value, _meta(planes, sr.value, "WAV", _WAV_SUBTYPES.get(subtype.value, "UNKNOWN")), mono


def decode_flac(path: str) -> Optional[Tuple[np.ndarray, int, Dict[str, object]]]:
    """Decode a FLAC file to channel-major float32, bit for bit
    ``io/flac.decode_flac``; None where the library declines the file."""

    lib = load()
    buf = _F32P()
    frames, channels, sr, bps = ctypes.c_longlong(0), ctypes.c_int(0), ctypes.c_int(0), ctypes.c_int(0)
    rc = lib.ta_decode_flac(
        str(path).encode(), ctypes.byref(buf), ctypes.byref(frames), ctypes.byref(channels),
        ctypes.byref(sr), ctypes.byref(bps),
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
    return data, sr.value, _meta(data, sr.value, "FLAC", f"PCM_{bps.value}")


def _checked(channels: np.ndarray, n_bucket: int, block: int = 1, group: int = 1) -> np.ndarray:
    """``channels`` as a contiguous (1|2, n) float32 array, checked
    against the output's size: n <= n_bucket, n_bucket a multiple of
    ``block``, ``block`` of ``group`` (a pack group must not straddle a
    block)."""

    x = np.ascontiguousarray(channels, dtype=np.float32)
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


def quantise_i8(channels: np.ndarray, n_bucket: int, block: int) -> Tuple[np.ndarray, np.ndarray]:
    """Pad + blockwise int8 of a (1|2, n) signal, a mono one duplicated:
    (values (2, n_bucket) int8, scales (2, n_bucket / block) float32)."""

    x = _checked(channels, n_bucket, block)
    vals = np.empty((2, n_bucket), dtype=np.int8)
    scales = np.empty((2, n_bucket // block), dtype=np.float32)
    load().ta_quantise_i8(_ptr(x, ctypes.c_float), x.shape[0], x.shape[1], n_bucket, block,
                          _ptr(vals, ctypes.c_int8), _ptr(scales, ctypes.c_float))
    return vals, scales


def quantise_i16(channels: np.ndarray, n_bucket: int) -> np.ndarray:
    """Pad + truncating int16 (full scale 32768) of a mono signal -> (n_bucket,)."""

    x = _checked(channels, n_bucket)
    if x.shape[0] != 1:
        raise ValueError("quantise_i16 takes one channel")
    out = np.empty(n_bucket, dtype=np.int16)
    load().ta_quantise_i16(_ptr(x, ctypes.c_float), x.shape[1], n_bucket, _ptr(out, ctypes.c_int16))
    return out


def quantise_i16_stereo(channels: np.ndarray, n_bucket: int) -> np.ndarray:
    """Pad + truncating int16 of a (1|2, n) signal -> (2, n_bucket)."""

    x = _checked(channels, n_bucket)
    out = np.empty((2, n_bucket), dtype=np.int16)
    load().ta_quantise_i16_stereo(_ptr(x, ctypes.c_float), x.shape[0], x.shape[1], n_bucket,
                                  _ptr(out, ctypes.c_int16))
    return out


def quantise_ms(
    channels: np.ndarray, n_bucket: int, block: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.float32, np.ndarray]:
    """Mid as blockwise int8 and side as blockwise int4 (two codes a byte)
    with the float64 stereo sums in one pass: (mid (n_bucket,) int8, mid
    scales, side (n_bucket / 2,) uint8, side scales, the side's
    quantisation noise power, stats (8,) float64). The port's transports
    ship the mid only (``quantise_mid``); its mid, scales and stats equal
    these bit for bit."""

    x = _checked(channels, n_bucket, block, 2)
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


def quantise_mid(
    channels: np.ndarray, n_bucket: int, block: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The "ms" transport's quantiser: the padded mid (l + r) / 2 as
    blockwise int8 and the float64 stereo sums, (mid (n_bucket,) int8,
    scales (n_bucket / block,) float32, stats (8,) float64); the payload
    of ``_quantise_mid_range(x, n, 0, n_bucket)``."""

    x = _checked(channels, n_bucket, block)
    mid = np.empty(n_bucket, dtype=np.int8)
    scales = np.empty(n_bucket // block, dtype=np.float32)
    stats = np.empty(8, dtype=np.float64)
    load().ta_quantise_mid(_ptr(x, ctypes.c_float), x.shape[0], x.shape[1], n_bucket, block,
                           _ptr(mid, ctypes.c_int8), _ptr(scales, ctypes.c_float), _ptr(stats, ctypes.c_double))
    return mid, scales, stats


def _quantise_subbyte(symbol: str, bits: int, channels: np.ndarray, n_bucket: int, block: int, carry: float):
    group = 4 if bits == 6 else 8
    x = _checked(channels, n_bucket, block, group)
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
    channels: np.ndarray, n_bucket: int, block: int, carry: float = 0.0
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, float]:
    """The "ms6" transport's quantiser: per block the better of raw and
    delta-with-error-feedback 6-bit codes, four packed into three bytes:
    (packed (3 n_bucket / 4,) uint8, scales (sign = mode), bases, stats
    (8,) float64, carry out); the payload of ``_quantise_mid6_range``.
    ``carry`` is the sample entering the first block."""

    return _quantise_subbyte("ta_quantise_mid6", 6, channels, n_bucket, block, carry)


def quantise_mid5(
    channels: np.ndarray, n_bucket: int, block: int, carry: float = 0.0
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, float]:
    """The "ms5" transport's quantiser: noise-shaped 5-bit codes, eight
    packed into five bytes; otherwise as :func:`quantise_mid6`."""

    return _quantise_subbyte("ta_quantise_mid5", 5, channels, n_bucket, block, carry)
