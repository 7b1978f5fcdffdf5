"""Audio decode: the JAX package's codec ladder, and the WAV/AIFF codecs.

``decode_file`` sniffs a file's first bytes and tries the tiers in the
JAX package's order:

1. the native WAV decoder (``native/binding.decode``; ``libta_native``
   builds at first use and is required);
2. the numpy WAV/RIFX or AIFF/AIFF-C codec here, or FLAC (the native
   decoder, then the numpy one in ``io/flac.py``), by the container;
3. Ogg Vorbis through the system libvorbisfile (``io/vorbis.py``), on
   ``OggS``;
4. MPEG audio through the system libmpg123 (``io/mpg123.py``), on an ID3
   tag, a frame sync or an .mp3/.mp2/.mpga suffix;
5. the catch-all ffmpeg tier (``io/ffmpeg.py``, libavformat);

then raises ``AudioDecodeError("Could not decode audio file: <path>")``
with the first-party codec's error as ``__cause__``. A tier is skipped
where its system library is absent; the ladder steps down where a
library declines a file or a codec raises a decode error
(``DECODE_ERRORS``). Any other exception, such as a ``TypeError`` from a
binding, propagates.

The WAV codec reads PCM 8/16/24/32, IEEE float32/64 and
WAVE_FORMAT_EXTENSIBLE in RIFF and big-endian RIFX containers; AIFF
reads PCM 16/24/32 big-endian, 'sowt' little-endian and fl32/fl64.
``write_wav`` writes PCM 16/24/32 or float WAV.
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Dict, Tuple

import numpy as np

__all__ = ["decode_file", "decode_wav", "write_wav", "AudioDecodeError", "DECODE_ERRORS"]

_WAVE_FORMAT_PCM = 0x0001
_WAVE_FORMAT_IEEE_FLOAT = 0x0003
_WAVE_FORMAT_EXTENSIBLE = 0xFFFE


class AudioDecodeError(RuntimeError):
    """Raised when no codec can decode the given file."""


# What a codec raises on a malformed or truncated file: a parser may fail
# before its own checks (struct.error, a ragged frombuffer, an index past
# the end). The decode ladder steps down on these and nothing else.
DECODE_ERRORS = (AudioDecodeError, OSError, struct.error, ValueError, IndexError)


def _pcm24_to_float32(raw: bytes) -> np.ndarray:
    """Decode packed little-endian 24-bit PCM to float32 in [-1, 1)."""

    buf = np.frombuffer(raw, dtype=np.uint8)
    usable = (buf.size // 3) * 3
    buf = buf[:usable].reshape(-1, 3)
    # Sign-extend into int32: place the 3 bytes in the top of a 32-bit word
    # then arithmetic-shift down 8.
    as_int = (
        buf[:, 0].astype(np.int32)
        | (buf[:, 1].astype(np.int32) << 8)
        | (buf[:, 2].astype(np.int32) << 16)
    )
    as_int = (as_int << 8) >> 8  # sign extension
    return (as_int.astype(np.float32)) / 8388608.0  # 2**23


def decode_wav(path: str | Path) -> Tuple[np.ndarray, int, Dict[str, object]]:
    """Decode a RIFF/WAVE file.

    Returns ``(data, sr, meta)`` with ``data`` channel-major float32 of
    shape ``(channels, frames)`` and ``meta`` carrying channels,
    duration, file_type and subtype.
    """

    raw = Path(path).read_bytes()
    # 'RIFX' is the big-endian RIFF variant (scipy/matlab write it for
    # be data): same structure with big-endian chunk sizes, fmt fields
    # and samples. First-party support matters because at least one
    # libavformat build misparses RIFX sample data as little-endian —
    # silent byte-swapped garbage, not an error.
    if len(raw) < 12 or raw[0:4] not in (b"RIFF", b"RIFX") or raw[8:12] != b"WAVE":
        raise AudioDecodeError(f"Not a RIFF/WAVE file: {path}")
    e = ">" if raw[0:4] == b"RIFX" else "<"

    fmt = None
    data_bytes = None
    pos = 12
    n = len(raw)
    while pos + 8 <= n:
        chunk_id = raw[pos : pos + 4]
        (chunk_size,) = struct.unpack_from(f"{e}I", raw, pos + 4)
        body = raw[pos + 8 : pos + 8 + chunk_size]
        if chunk_id == b"fmt ":
            if chunk_size < 16:
                raise AudioDecodeError(f"Malformed fmt chunk in {path}")
            audio_format, channels, sr, _byte_rate, block_align, bits = (
                struct.unpack_from(f"{e}HHIIHH", body, 0)
            )
            if audio_format == _WAVE_FORMAT_EXTENSIBLE and chunk_size >= 40:
                # SubFormat GUID: Data1 carries the real format tag, and
                # follows the container's endianness (RIFX stores it
                # big-endian).
                (audio_format,) = struct.unpack_from(f"{e}I", body, 24)
                audio_format &= 0xFFFF
            fmt = (audio_format, channels, sr, block_align, bits)
        elif chunk_id == b"data":
            data_bytes = body
        pos += 8 + chunk_size + (chunk_size & 1)  # chunks are word-aligned

    if fmt is None or data_bytes is None:
        raise AudioDecodeError(f"Missing fmt/data chunk in {path}")

    audio_format, channels, sr, _block_align, bits = fmt
    if channels <= 0 or sr <= 0:
        raise AudioDecodeError(f"Invalid WAV header in {path}")

    if audio_format == _WAVE_FORMAT_PCM:
        if bits == 16:
            flat = np.frombuffer(data_bytes, dtype=f"{e}i2").astype(np.float32) / 32768.0
            subtype = "PCM_16"
        elif bits == 24:
            buf = data_bytes
            if e == ">":  # swap each packed triplet to little-endian
                b24 = np.frombuffer(buf, dtype=np.uint8)
                usable = (b24.size // 3) * 3
                buf = b24[:usable].reshape(-1, 3)[:, ::-1].reshape(-1).tobytes()
            flat = _pcm24_to_float32(buf)
            subtype = "PCM_24"
        elif bits == 32:
            flat = (
                np.frombuffer(data_bytes, dtype=f"{e}i4").astype(np.float32) / 2147483648.0
            )
            subtype = "PCM_32"
        elif bits == 8:
            flat = (
                np.frombuffer(data_bytes, dtype=np.uint8).astype(np.float32) - 128.0
            ) / 128.0
            subtype = "PCM_U8"
        else:
            raise AudioDecodeError(f"Unsupported PCM bit depth {bits} in {path}")
    elif audio_format == _WAVE_FORMAT_IEEE_FLOAT:
        if bits == 32:
            flat = np.frombuffer(data_bytes, dtype=f"{e}f4").astype(np.float32)
            subtype = "FLOAT"
        elif bits == 64:
            flat = np.frombuffer(data_bytes, dtype=f"{e}f8").astype(np.float32)
            subtype = "DOUBLE"
        else:
            raise AudioDecodeError(f"Unsupported float bit depth {bits} in {path}")
    else:
        raise AudioDecodeError(
            f"Unsupported WAV format tag 0x{audio_format:04x} in {path}"
        )

    frames = flat.size // channels
    data = flat[: frames * channels].reshape(frames, channels).T
    data = np.ascontiguousarray(data, dtype=np.float32)
    meta: Dict[str, object] = {
        "channels": int(channels),
        "duration": frames / float(sr),
        "file_type": "WAV",
        "subtype": subtype,
    }
    return data, int(sr), meta


def _decode_aiff(path: str | Path) -> Tuple[np.ndarray, int, Dict[str, object]]:
    raw = Path(path).read_bytes()
    if len(raw) < 12 or raw[0:4] != b"FORM" or raw[8:12] not in (b"AIFF", b"AIFC"):
        raise AudioDecodeError(f"Not an AIFF file: {path}")
    is_aifc = raw[8:12] == b"AIFC"
    channels = sr = bits = None
    comp = b"NONE"
    sound = None
    pos = 12
    while pos + 8 <= len(raw):
        chunk_id = raw[pos : pos + 4]
        (chunk_size,) = struct.unpack_from(">I", raw, pos + 4)
        body = raw[pos + 8 : pos + 8 + chunk_size]
        if chunk_id == b"COMM":
            channels, _frames, bits = struct.unpack_from(">hIh", body, 0)
            # 80-bit extended float sample rate
            exponent = struct.unpack_from(">H", body, 8)[0] & 0x7FFF
            mantissa = struct.unpack_from(">Q", body, 10)[0]
            sr = int(mantissa * 2.0 ** (exponent - 16383 - 63))
            if is_aifc and chunk_size >= 22:
                comp = body[18:22]  # AIFF-C compressionType
        elif chunk_id == b"SSND":
            (offset, _blocksize) = struct.unpack_from(">II", body, 0)
            sound = body[8 + offset :]
        pos += 8 + chunk_size + (chunk_size & 1)
    if channels is None or sr is None or sound is None:
        raise AudioDecodeError(f"Malformed AIFF file: {path}")
    # AIFF-C compressionType decides the sample encoding. 'sowt'
    # (little-endian PCM, the macOS/iTunes default) and float types MUST
    # NOT be read as big-endian integers — that silently decodes
    # byte-swapped noise. Unknown codecs raise so decode_file's ladder
    # routes the file to the ffmpeg tier.
    comp_s = comp.decode("ascii", errors="replace").strip().lower()
    if comp_s in ("none", "twos", ""):
        endian = ">"
        is_float = False
    elif comp_s == "sowt":
        endian = "<"
        is_float = False
    elif comp_s in ("fl32", "fl64"):
        endian = ">"
        is_float = True
    else:
        raise AudioDecodeError(f"Unsupported AIFF-C codec {comp!r} in {path}")
    if is_float and bits == 32:
        flat = np.frombuffer(sound, dtype=">f4").astype(np.float32)
    elif is_float and bits == 64:
        flat = np.frombuffer(sound, dtype=">f8").astype(np.float32)
    elif not is_float and bits == 16:
        flat = np.frombuffer(sound, dtype=f"{endian}i2").astype(np.float32) / 32768.0
    elif not is_float and bits == 24:
        buf = np.frombuffer(sound, dtype=np.uint8)
        usable = (buf.size // 3) * 3
        if endian == ">":  # big-endian packed: swap each triplet
            buf = buf[:usable].reshape(-1, 3)[:, ::-1].reshape(-1)
        else:
            buf = buf[:usable]
        flat = _pcm24_to_float32(buf.tobytes())
    elif not is_float and bits == 32:
        flat = np.frombuffer(sound, dtype=f"{endian}i4").astype(np.float32) / 2147483648.0
    else:
        raise AudioDecodeError(f"Unsupported AIFF bit depth {bits} in {path}")
    frames = flat.size // channels
    data = np.ascontiguousarray(
        flat[: frames * channels].reshape(frames, channels).T, dtype=np.float32
    )
    meta: Dict[str, object] = {
        "channels": int(channels),
        "duration": frames / float(sr),
        "file_type": "AIFF",
        "subtype": "FLOAT" if is_float else f"PCM_{bits}",
    }
    return data, int(sr), meta


def decode_file(path: str | Path) -> Tuple[np.ndarray, int, Dict[str, object]]:
    """Decode ``path`` through the codec ladder (see the module docstring).

    Returns ``(data, sr, meta)`` with ``data`` channel-major float32.
    """

    from ..native import binding
    from . import ffmpeg, flac, mpg123, vorbis

    file_path = str(path)
    try:
        with open(file_path, "rb") as fh:  # sniff only; decoders re-read
            head = fh.read(12)
    except OSError as exc:
        raise AudioDecodeError(f"Could not decode audio file: {file_path}") from exc

    result = binding.decode(file_path)
    if result is not None:
        return result

    first_party_error: "Exception | None" = None
    try:
        if head[0:4] in (b"RIFF", b"RIFX"):
            return decode_wav(file_path)
        if head[0:4] == b"FORM":
            return _decode_aiff(file_path)
        if head[0:4] == b"fLaC":
            result = binding.decode_flac(file_path)
            return result if result is not None else flac.decode_flac(file_path)
    except DECODE_ERRORS as exc:
        # A valid container the first-party codec does not cover (ADPCM in
        # WAV, say) may still decode through the ffmpeg tier below.
        first_party_error = exc

    if head[0:4] == b"OggS" and vorbis.available():
        try:
            return vorbis.decode_ogg(file_path)
        except DECODE_ERRORS:
            pass

    looks_mpeg = head[0:3] == b"ID3" or (len(head) >= 2 and head[0] == 0xFF and (head[1] & 0xE0) == 0xE0)
    if (looks_mpeg or Path(file_path).suffix.lower() in (".mp3", ".mp2", ".mpga")) and mpg123.available():
        try:
            return mpg123.decode_mp3(file_path)
        except DECODE_ERRORS:
            pass

    if ffmpeg.available():
        result = ffmpeg.decode(file_path)
        if result is not None:
            return result

    raise AudioDecodeError(f"Could not decode audio file: {file_path}") from first_party_error


def write_wav(
    path: str | Path,
    data: np.ndarray,
    sample_rate: int,
    *,
    subtype: str = "PCM_16",
) -> None:
    """Write ``data`` (``(frames,)`` or ``(frames, channels)`` or
    ``(channels, frames)`` float in [-1, 1]) to a WAV file. For
    ``PCM_16``, int16 ``data`` is taken as samples already quantised."""

    arr = np.asarray(data)
    if not (subtype == "PCM_16" and arr.dtype == np.int16):
        arr = arr.astype(np.float64)
    if arr.ndim == 1:
        arr = arr[:, None]
    elif arr.shape[0] <= 8 and arr.shape[0] < arr.shape[1]:
        arr = arr.T  # channel-major input
    frames, channels = arr.shape

    if subtype == "PCM_16":
        ints = arr if arr.dtype == np.int16 else np.clip(np.round(arr * 32767.0), -32768, 32767)
        payload = np.ascontiguousarray(ints, dtype="<i2")
        bits, tag = 16, _WAVE_FORMAT_PCM
    elif subtype == "PCM_24":
        ints = np.clip(np.round(arr * 8388607.0), -8388608, 8388607).astype(np.int32)
        payload = np.empty((frames * channels, 3), dtype=np.uint8)
        flat = ints.reshape(-1)
        payload[:, 0] = flat & 0xFF
        payload[:, 1] = (flat >> 8) & 0xFF
        payload[:, 2] = (flat >> 16) & 0xFF
        bits, tag = 24, _WAVE_FORMAT_PCM
    elif subtype == "PCM_32":
        payload = np.ascontiguousarray(
            np.clip(np.round(arr * 2147483647.0), -2147483648, 2147483647), dtype="<i4"
        )
        bits, tag = 32, _WAVE_FORMAT_PCM
    elif subtype == "FLOAT":
        payload = np.ascontiguousarray(arr, dtype="<f4")
        bits, tag = 32, _WAVE_FORMAT_IEEE_FLOAT
    else:
        raise ValueError(f"Unsupported WAV subtype: {subtype}")

    byte_rate = sample_rate * channels * bits // 8
    block_align = channels * bits // 8
    fmt = struct.pack(
        "<HHIIHH", tag, channels, sample_rate, byte_rate, block_align, bits
    )
    fmt_chunk = b"fmt " + struct.pack("<I", len(fmt)) + fmt
    riff_size = 4 + len(fmt_chunk) + 8 + payload.nbytes
    header = b"RIFF" + struct.pack("<I", riff_size) + b"WAVE" + fmt_chunk
    # The samples go to the file from the array's own buffer, not a copy.
    with open(path, "wb") as f:
        f.write(header + b"data" + struct.pack("<I", payload.nbytes))
        f.write(memoryview(payload).cast("B"))
