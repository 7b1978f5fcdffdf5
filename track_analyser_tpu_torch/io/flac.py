"""FLAC codec in numpy: the decoder the decode ladder uses where the
native library declines a stream, and the encoder that writes the tests'
fixtures (and the chip smoke run's 181 s FLAC). A copy of the JAX
package's ``io/flac.py``, whose encoder writes its Rice codes and
verbatim samples as bit vectors in one numpy pass where the JAX one
writes a field at a time: the same bytes.

* decoder: STREAMINFO + frame parsing, CONSTANT / VERBATIM / FIXED(0-4) /
  LPC(1-32) subframes, Rice/Rice2 residual partitions with escape codes,
  wasted bits, left/right/mid-side decorrelation, 8/12/16/20/24/32 bps.
  Frame-header CRC-8 is verified; output is channel-major float32.
* encoder: enough of the format to produce real, spec-valid files for
  fixtures and round-trip tests: fixed-order prediction (best of 0-2),
  one quantised LPC candidate, exact-cost Rice parameter search,
  CONSTANT/VERBATIM fallbacks, correct CRC-8/CRC-16.

Decoding is numpy-first: the whole stream is unpacked to a bit vector
once, Rice quotients ride a precomputed set-bit index (the only
per-sample Python work is advancing that index), and remainders /
verbatim samples / warmups are gathered as (count, width) bit matrices
and folded with one matmul. Fixed-order prediction is inverted with
cumulative sums.
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

from .codecs import AudioDecodeError

__all__ = ["decode_flac", "encode_flac"]

_BLOCK_SIZES = {
    1: 192, 2: 576, 3: 1152, 4: 2304, 5: 4608,
    8: 256, 9: 512, 10: 1024, 11: 2048, 12: 4096, 13: 8192, 14: 16384, 15: 32768,
}
_SAMPLE_RATES = {
    1: 88_200, 2: 176_400, 3: 192_000, 4: 8_000, 5: 16_000, 6: 22_050,
    7: 24_000, 8: 32_000, 9: 44_100, 10: 48_000, 11: 96_000,
}
_SAMPLE_SIZES = {1: 8, 2: 12, 4: 16, 5: 20, 6: 24, 7: 32}


# ---------------------------------------------------------------------------
# CRCs (FLAC spec: CRC-8 poly 0x07, CRC-16 poly 0x8005, both init 0)
# ---------------------------------------------------------------------------


def _crc_table(poly: int, width: int) -> np.ndarray:
    top = 1 << (width - 1)
    mask = (1 << width) - 1
    table = np.zeros(256, dtype=np.uint32)
    for byte in range(256):
        crc = byte << (width - 8)
        for _ in range(8):
            crc = ((crc << 1) ^ poly) if crc & top else (crc << 1)
        table[byte] = crc & mask
    return table


_CRC8_TABLE = _crc_table(0x07, 8)
_CRC16_TABLE = _crc_table(0x8005, 16)


def _crc8(data: bytes) -> int:
    crc = 0
    for b in data:
        crc = int(_CRC8_TABLE[crc ^ b])
    return crc


def _crc16(data: bytes) -> int:
    crc = 0
    for b in data:
        crc = ((crc << 8) & 0xFFFF) ^ int(_CRC16_TABLE[((crc >> 8) ^ b) & 0xFF])
    return crc


# ---------------------------------------------------------------------------
# Bit reader
# ---------------------------------------------------------------------------


class _BitReader:
    __slots__ = ("raw", "bits", "ones", "pos", "_one_ptr")

    def __init__(self, raw: bytes):
        self.raw = raw
        self.bits = np.unpackbits(np.frombuffer(raw, dtype=np.uint8))
        self.ones = np.flatnonzero(self.bits).astype(np.int64)
        self.pos = 0
        self._one_ptr = 0

    def read(self, n: int) -> int:
        """n-bit big-endian unsigned integer."""

        if n == 0:
            return 0
        p = self.pos
        self.pos = p + n
        value = 0
        for bit in self.bits[p : p + n]:
            value = (value << 1) | int(bit)
        return value

    def read_signed(self, n: int) -> int:
        value = self.read(n)
        return value - (1 << n) if value >= (1 << (n - 1)) else value

    def read_unary(self) -> int:
        """Count of 0 bits before the next 1 bit (which is consumed)."""

        j = int(np.searchsorted(self.ones, self.pos))
        if j >= self.ones.size:
            raise AudioDecodeError("FLAC bitstream truncated in unary field")
        stop = int(self.ones[j])
        q = stop - self.pos
        self.pos = stop + 1
        return q

    def read_block_unsigned(self, count: int, width: int) -> np.ndarray:
        """(count,) unsigned ints of ``width`` bits each — one gather+fold."""

        if count == 0 or width == 0:
            return np.zeros(count, dtype=np.int64)
        idx = self.pos + np.arange(count, dtype=np.int64)[:, None] * width
        idx = idx + np.arange(width, dtype=np.int64)[None, :]
        if int(idx[-1, -1]) >= self.bits.size:
            raise AudioDecodeError("FLAC bitstream truncated in sample block")
        weights = (1 << np.arange(width - 1, -1, -1, dtype=np.int64))
        out = self.bits[idx].astype(np.int64) @ weights
        self.pos += count * width
        return out

    def read_block_signed(self, count: int, width: int) -> np.ndarray:
        vals = self.read_block_unsigned(count, width)
        if width:
            sign = 1 << (width - 1)
            vals = np.where(vals >= sign, vals - (1 << width), vals)
        return vals

def _read_rice_block(reader: _BitReader, count: int, param: int) -> np.ndarray:
    """``count`` Rice-coded signed residuals with parameter ``param``.

    The only sequential work is walking the precomputed set-bit index to
    find each code's unary terminator (set bits inside remainder fields
    are skipped by position, so the walk is linear in total set bits);
    remainders fold as one (count, param) gather + matmul, and the zigzag
    unmap is vectorised."""

    if count == 0:
        return np.zeros(0, dtype=np.int64)
    start0 = reader.pos
    ones = reader.ones
    n_ones = ones.size
    stops = np.empty(count, dtype=np.int64)
    pos = start0
    j = int(np.searchsorted(ones, pos))
    for i in range(count):
        while j < n_ones and ones[j] < pos:
            j += 1
        if j >= n_ones:
            raise AudioDecodeError("FLAC bitstream truncated in Rice field")
        stop = int(ones[j])
        stops[i] = stop
        pos = stop + 1 + param
        j += 1
    reader.pos = int(pos)

    quotients = np.empty(count, dtype=np.int64)
    quotients[0] = stops[0] - start0
    if count > 1:
        quotients[1:] = stops[1:] - (stops[:-1] + 1 + param)

    if param:
        idx = stops[:, None] + 1 + np.arange(param, dtype=np.int64)[None, :]
        weights = 1 << np.arange(param - 1, -1, -1, dtype=np.int64)
        rems = reader.bits[idx].astype(np.int64) @ weights
    else:
        rems = np.zeros(count, dtype=np.int64)

    folded = (quotients << param) | rems
    return (folded >> 1) ^ -(folded & 1)


# ---------------------------------------------------------------------------
# Prediction inverses
# ---------------------------------------------------------------------------


def _fixed_restore(residual: np.ndarray, warmup: np.ndarray, order: int) -> np.ndarray:
    """Invert the order-``order`` difference: k nested cumulative sums,
    each seeded by the warmup's matching finite difference."""

    if order == 0:
        return np.asarray(residual, dtype=np.int64)
    w = np.asarray(warmup, dtype=np.int64)
    cur = np.asarray(residual, dtype=np.int64)
    for level in range(order - 1, -1, -1):
        seed = np.diff(w, n=level)[-1] if level else w[-1]
        cur = seed + np.cumsum(cur)
    return np.concatenate([w, cur])


def _lpc_restore(
    residual: np.ndarray, warmup: np.ndarray, coefs: List[int], shift: int
) -> np.ndarray:
    order = len(coefs)
    n = residual.size + order
    out = np.empty(n, dtype=np.int64)
    out[:order] = warmup
    taps = np.asarray(coefs[::-1], dtype=np.int64)
    res = np.asarray(residual, dtype=np.int64)
    for i in range(order, n):
        out[i] = res[i - order] + (int(out[i - order : i] @ taps) >> shift)
    return out


# ---------------------------------------------------------------------------
# Decoder
# ---------------------------------------------------------------------------


def _read_utf8_coded(reader: _BitReader) -> int:
    first = reader.read(8)
    if first < 0x80:
        return first
    n_extra = 0
    mask = 0x40
    while first & mask:
        n_extra += 1
        mask >>= 1
    value = first & (mask - 1)
    for _ in range(n_extra):
        cont = reader.read(8)
        if cont & 0xC0 != 0x80:
            raise AudioDecodeError("Malformed UTF-8-coded FLAC frame number")
        value = (value << 6) | (cont & 0x3F)
    return value


def _read_residual(reader: _BitReader, block_size: int, pred_order: int) -> np.ndarray:
    method = reader.read(2)
    if method > 1:
        raise AudioDecodeError(f"Reserved FLAC residual method {method}")
    param_bits = 4 if method == 0 else 5
    escape = (1 << param_bits) - 1
    part_order = reader.read(4)
    n_parts = 1 << part_order
    if block_size % n_parts or ((block_size >> part_order) <= pred_order and n_parts > 1):
        # spec: block size must divide evenly, and the first partition
        # (which is pred_order samples short) must still have >0 samples
        raise AudioDecodeError("Invalid FLAC partition layout")
    pieces = []
    for part in range(n_parts):
        count = (block_size >> part_order) - (pred_order if part == 0 else 0)
        if count < 0:
            raise AudioDecodeError("Invalid FLAC partition layout")
        param = reader.read(param_bits)
        if param == escape:
            raw_bits = reader.read(5)
            pieces.append(reader.read_block_signed(count, raw_bits))
        else:
            pieces.append(_read_rice_block(reader, count, param))
    return np.concatenate(pieces) if pieces else np.zeros(0, dtype=np.int64)


def _read_subframe(reader: _BitReader, block_size: int, bps: int) -> np.ndarray:
    if reader.read(1) != 0:
        raise AudioDecodeError("FLAC subframe padding bit set")
    sf_type = reader.read(6)
    wasted = 0
    if reader.read(1):
        wasted = reader.read_unary() + 1
    eff_bps = bps - wasted

    if sf_type == 0:  # CONSTANT
        value = reader.read_signed(eff_bps)
        out = np.full(block_size, value, dtype=np.int64)
    elif sf_type == 1:  # VERBATIM
        out = reader.read_block_signed(block_size, eff_bps)
    elif 8 <= sf_type <= 12:  # FIXED, order 0-4
        order = sf_type - 8
        warmup = reader.read_block_signed(order, eff_bps)
        residual = _read_residual(reader, block_size, order)
        out = _fixed_restore(residual, warmup, order)
    elif sf_type >= 32:  # LPC, order 1-32
        order = sf_type - 31
        warmup = reader.read_block_signed(order, eff_bps)
        precision = reader.read(4) + 1
        if precision == 16:
            raise AudioDecodeError("Invalid FLAC LPC precision")
        shift = reader.read_signed(5)
        if shift < 0:
            raise AudioDecodeError("Negative FLAC LPC shift")
        coefs = [reader.read_signed(precision) for _ in range(order)]
        residual = _read_residual(reader, block_size, order)
        out = _lpc_restore(residual, warmup, coefs, shift)
    else:
        raise AudioDecodeError(f"Reserved FLAC subframe type {sf_type}")

    return out << wasted if wasted else out


def _decode_frame(
    reader: _BitReader, info: Dict[str, int]
) -> Tuple[np.ndarray, int]:
    """Decode one frame -> (samples (channels, block_size) int64, sr)."""

    header_start_byte = reader.pos // 8
    sync = reader.read(14)
    if sync != 0b11111111111110:
        raise AudioDecodeError("Lost FLAC frame sync")
    reader.read(1)  # reserved
    reader.read(1)  # blocking strategy
    bs_code = reader.read(4)
    sr_code = reader.read(4)
    ch_code = reader.read(4)
    ss_code = reader.read(3)
    reader.read(1)  # reserved
    _read_utf8_coded(reader)

    if bs_code == 6:
        block_size = reader.read(8) + 1
    elif bs_code == 7:
        block_size = reader.read(16) + 1
    elif bs_code in _BLOCK_SIZES:
        block_size = _BLOCK_SIZES[bs_code]
    else:
        raise AudioDecodeError(f"Reserved FLAC block size code {bs_code}")

    if sr_code == 0:
        sr = info["sample_rate"]
    elif sr_code in _SAMPLE_RATES:
        sr = _SAMPLE_RATES[sr_code]
    elif sr_code == 12:
        sr = reader.read(8) * 1000
    elif sr_code == 13:
        sr = reader.read(16)
    elif sr_code == 14:
        sr = reader.read(16) * 10
    else:
        raise AudioDecodeError("Invalid FLAC sample rate code")

    bps = info["bits_per_sample"] if ss_code == 0 else _SAMPLE_SIZES.get(ss_code)
    if bps is None:
        raise AudioDecodeError(f"Reserved FLAC sample size code {ss_code}")

    # CRC-8 covers the header bytes up to (not including) the CRC byte.
    header_end_byte = reader.pos // 8
    if reader.pos % 8:
        raise AudioDecodeError("FLAC frame header not byte-aligned")
    expected_crc8 = reader.read(8)
    actual = _crc8(reader.raw[header_start_byte:header_end_byte])
    if actual != expected_crc8:
        raise AudioDecodeError("FLAC frame header CRC-8 mismatch")

    if ch_code <= 7:
        channels = [
            _read_subframe(reader, block_size, bps) for _ in range(ch_code + 1)
        ]
        frame = np.stack(channels)
    elif ch_code in (8, 9, 10):
        # Stereo decorrelation: the side channel carries one extra bit.
        if ch_code == 8:  # left/side
            left = _read_subframe(reader, block_size, bps)
            side = _read_subframe(reader, block_size, bps + 1)
            frame = np.stack([left, left - side])
        elif ch_code == 9:  # right/side
            side = _read_subframe(reader, block_size, bps + 1)
            right = _read_subframe(reader, block_size, bps)
            frame = np.stack([right + side, right])
        else:  # mid/side
            mid = _read_subframe(reader, block_size, bps)
            side = _read_subframe(reader, block_size, bps + 1)
            mid2 = (mid << 1) | (side & 1)
            frame = np.stack([(mid2 + side) >> 1, (mid2 - side) >> 1])
    else:
        raise AudioDecodeError(f"Reserved FLAC channel assignment {ch_code}")

    # Byte-align and consume the footer CRC-16.
    if reader.pos % 8:
        reader.pos += 8 - (reader.pos % 8)
    reader.read(16)
    return frame, sr


def decode_flac(path: "str | Path") -> Tuple[np.ndarray, int, Dict[str, object]]:
    """Decode a FLAC file to channel-major float32 in [-1, 1)."""

    raw = Path(path).read_bytes()
    if raw[:4] != b"fLaC":
        raise AudioDecodeError(f"Not a FLAC file: {path}")

    # Metadata blocks: STREAMINFO is mandatory and first.
    pos = 4
    info: Dict[str, int] = {}
    while pos + 4 <= len(raw):
        header = struct.unpack_from(">I", raw, pos)[0]
        last = bool(header >> 31)
        block_type = (header >> 24) & 0x7F
        length = header & 0xFFFFFF
        body = raw[pos + 4 : pos + 4 + length]
        if block_type == 0:
            if length < 34:
                raise AudioDecodeError(f"Truncated FLAC STREAMINFO in {path}")
            packed = int.from_bytes(body[10:18], "big")
            info = {
                "sample_rate": packed >> 44,
                "channels": ((packed >> 41) & 0x7) + 1,
                "bits_per_sample": ((packed >> 36) & 0x1F) + 1,
                "total_samples": packed & ((1 << 36) - 1),
            }
        pos += 4 + length
        if last:
            break
    if not info or info["sample_rate"] == 0:
        raise AudioDecodeError(f"Missing FLAC STREAMINFO in {path}")

    reader = _BitReader(raw)
    reader.pos = pos * 8

    frames: List[np.ndarray] = []
    decoded = 0
    total = info["total_samples"]
    sr = info["sample_rate"]
    while (total == 0 or decoded < total) and reader.pos + 32 <= reader.bits.size:
        frame, sr = _decode_frame(reader, info)
        frames.append(frame)
        decoded += frame.shape[1]
        if total == 0 and reader.pos + 32 > reader.bits.size:
            break

    if not frames:
        raise AudioDecodeError(f"No FLAC frames decoded from {path}")
    samples = np.concatenate(frames, axis=1)
    if total:
        samples = samples[:, :total]
    bps = info["bits_per_sample"]
    data = (samples.astype(np.float64) / float(1 << (bps - 1))).astype(np.float32)
    meta: Dict[str, object] = {
        "channels": int(info["channels"]),
        "duration": samples.shape[1] / float(sr),
        "file_type": "FLAC",
        "subtype": f"PCM_{bps}",
    }
    return np.ascontiguousarray(data), int(sr), meta


# ---------------------------------------------------------------------------
# Encoder (fixtures + round-trip tests)
# ---------------------------------------------------------------------------


class _BitWriter:
    def __init__(self) -> None:
        self.buf = bytearray()
        self.acc = 0
        self.nbits = 0

    def write(self, value: int, n: int) -> None:
        if n == 0:
            return
        self.acc = (self.acc << n) | (int(value) & ((1 << n) - 1))
        self.nbits += n
        while self.nbits >= 8:
            self.nbits -= 8
            self.buf.append((self.acc >> self.nbits) & 0xFF)
        self.acc &= (1 << self.nbits) - 1

    def write_signed(self, value: int, n: int) -> None:
        self.write(value & ((1 << n) - 1), n)

    def write_bits(self, bits: np.ndarray) -> None:
        """Append a vector of 0/1 bits (uint8), first bit first: what a
        ``write`` per field would append, packed in one numpy pass."""

        if bits.size == 0:
            return
        if self.nbits:
            pending = (self.acc >> np.arange(self.nbits - 1, -1, -1)) & 1
            bits = np.concatenate([pending.astype(np.uint8), bits])
        whole = bits.size - bits.size % 8
        self.buf += np.packbits(bits[:whole]).tobytes()
        self.nbits = int(bits.size - whole)
        self.acc = 0
        for bit in bits[whole:]:
            self.acc = (self.acc << 1) | int(bit)

    def align(self) -> None:
        if self.nbits:
            self.write(0, 8 - self.nbits)

    def bytes(self) -> bytes:
        assert self.nbits == 0
        return bytes(self.buf)


def _field_bits(values: np.ndarray, width: int) -> np.ndarray:
    """(count * width,) bits of ``values`` as ``width``-bit two's-complement
    fields, each most significant bit first."""

    shifts = np.arange(width - 1, -1, -1, dtype=np.int64)
    return ((np.asarray(values, dtype=np.int64)[:, None] >> shifts) & 1).astype(np.uint8).reshape(-1)


def _utf8_coded(value: int) -> bytes:
    """FLAC's UTF-8-style variable-length number (frame/sample index)."""

    if value < 0x80:
        return bytes([value])
    # An n-byte sequence (2 <= n <= 7) carries (7 - n) + 6*(n - 1) bits.
    n_bytes = next(n for n in range(2, 8) if value < (1 << ((7 - n) + 6 * (n - 1))))
    shift = 6 * (n_bytes - 1)
    lead = ((0xFF << (8 - n_bytes)) & 0xFF) | (value >> shift)
    tail = [0x80 | ((value >> (shift - 6 * (k + 1))) & 0x3F) for k in range(n_bytes - 1)]
    return bytes([lead] + tail)


def _zigzag(values: np.ndarray) -> np.ndarray:
    return (values << 1) ^ (values >> 63)


def _rice_cost(zz: np.ndarray, param: int) -> int:
    return int(np.sum(zz >> param)) + zz.size * (param + 1)


def _best_rice_param(zz: np.ndarray) -> Tuple[int, int]:
    best_p, best_cost = 0, _rice_cost(zz, 0)
    for p in range(1, 15):
        cost = _rice_cost(zz, p)
        if cost < best_cost:
            best_p, best_cost = p, cost
    return best_p, best_cost


def _write_rice(writer: _BitWriter, zz: np.ndarray, param: int) -> None:
    """Rice codes of the non-negative ``zz``: per value, q = v >> param
    zeros, a terminating 1, then v's low ``param`` bits (the JAX
    package's per-value writes, laid out in one bit vector)."""

    zz = np.asarray(zz, dtype=np.int64)
    if zz.size == 0:
        return
    q = zz >> param
    lengths = q + 1 + param
    starts = np.cumsum(lengths) - lengths
    bits = np.zeros(int(lengths.sum()), dtype=np.uint8)
    bits[starts + q] = 1
    if param:
        low = _field_bits(zz & ((1 << param) - 1), param).reshape(-1, param)
        bits[(starts + q + 1)[:, None] + np.arange(param)] = low
    writer.write_bits(bits)


_LPC_PRECISION = 12  # quantised coefficient bits (the common encoder choice)


def _lpc_candidate(samples: np.ndarray, order: int):
    """Quantised-LPC candidate: (coefs, shift, residual) or None.

    Standard recipe: windowed autocorrelation -> Levinson-Durbin ->
    coefficient quantisation to _LPC_PRECISION bits with a shared shift.
    The residual uses the decoder's exact integer arithmetic (dot then
    arithmetic >> shift), so round-trips are lossless by construction.
    """

    n = samples.size
    if n <= order * 2:
        return None
    x = samples.astype(np.float64) * np.hanning(n)
    ac = np.correlate(x, x, mode="full")[n - 1 : n + order]
    if ac[0] <= 0:
        return None
    # Levinson-Durbin
    err = ac[0]
    coefs = np.zeros(order)
    for i in range(order):
        acc = ac[i + 1] - coefs[:i] @ ac[i:0:-1]
        k = acc / err
        coefs[: i + 1] = np.append(coefs[:i] - k * coefs[:i][::-1], 0)[: i + 1]
        coefs[i] = k
        err *= 1.0 - k * k
        if err <= 0:
            return None

    cmax = np.max(np.abs(coefs))
    if cmax <= 0:
        return None
    shift = min(14, max(1, _LPC_PRECISION - 1 - int(np.ceil(np.log2(cmax + 1e-9))) - 1))
    q = np.clip(
        np.round(coefs * (1 << shift)),
        -(1 << (_LPC_PRECISION - 1)),
        (1 << (_LPC_PRECISION - 1)) - 1,
    ).astype(np.int64)
    if not np.any(q):
        return None

    # Integer residual with decoder-exact arithmetic.
    windows = np.lib.stride_tricks.sliding_window_view(samples, order)[:-1]
    pred = (windows @ q[::-1]) >> shift
    residual = samples[order:] - pred
    return q, shift, residual


def _encode_subframe(writer: _BitWriter, samples: np.ndarray, bps: int) -> None:
    samples = np.asarray(samples, dtype=np.int64)
    n = samples.size

    if np.all(samples == samples[0]):  # CONSTANT
        writer.write(0, 1)
        writer.write(0, 6)
        writer.write(0, 1)
        writer.write_signed(int(samples[0]), bps)
        return

    # Candidates: fixed orders 0-2 and one quantised LPC (order 8).
    best = None
    for order in range(0, 3):
        if n <= order:
            break
        residual = np.diff(samples, n=order) if order else samples.copy()
        zz = _zigzag(residual)
        param, cost = _best_rice_param(zz)
        total = cost + order * bps
        if best is None or total < best[0]:
            best = (total, "fixed", order, None, 0, zz, param)

    lpc_order = 8
    lpc = _lpc_candidate(samples, lpc_order)
    if lpc is not None:
        coefs, shift, residual = lpc
        zz = _zigzag(residual)
        param, cost = _best_rice_param(zz)
        total = cost + lpc_order * bps + 4 + 5 + lpc_order * _LPC_PRECISION
        if best is None or total < best[0]:
            best = (total, "lpc", lpc_order, coefs, shift, zz, param)

    verbatim_cost = n * bps
    if best is None or best[0] >= verbatim_cost:
        writer.write(0, 1)
        writer.write(1, 6)  # VERBATIM
        writer.write(0, 1)
        writer.write_bits(_field_bits(samples, bps))
        return

    _, kind, order, coefs, shift, zz, param = best
    writer.write(0, 1)
    writer.write((8 + order) if kind == "fixed" else (31 + order), 6)
    writer.write(0, 1)  # no wasted bits
    for v in samples[:order]:
        writer.write_signed(int(v), bps)
    if kind == "lpc":
        writer.write(_LPC_PRECISION - 1, 4)
        writer.write_signed(shift, 5)
        for c in coefs:
            writer.write_signed(int(c), _LPC_PRECISION)
    writer.write(0, 2)  # residual method 0 (4-bit Rice)
    writer.write(0, 4)  # partition order 0
    writer.write(param, 4)
    _write_rice(writer, zz, param)


def encode_flac(
    path: "str | Path",
    data: np.ndarray,
    sample_rate: int,
    *,
    bits_per_sample: int = 16,
    block_size: int = 4096,
    stereo_mode: str = "independent",
) -> Path:
    """Encode float [-1, 1] (or integer) samples as a spec-valid FLAC file.

    ``data``: (frames,), (channels, frames) or (frames, channels). Float
    input is quantised to ``bits_per_sample``; integer input is taken
    as-is (caller guarantees range). ``stereo_mode``: "independent" or
    "mid-side" (2-channel input only; mid=(L+R)>>1 at bps, side=L-R at
    bps+1 — channel assignment 10).
    """

    arr = np.asarray(data)
    if arr.ndim == 1:
        arr = arr[None, :]
    elif arr.shape[0] > arr.shape[1]:
        arr = arr.T
    channels, n = arr.shape
    if not 1 <= channels <= 8:
        raise ValueError(f"FLAC supports 1-8 channels, got {channels}")

    if np.issubdtype(arr.dtype, np.floating):
        full = float(1 << (bits_per_sample - 1))
        ints = np.clip(np.round(arr * full), -full, full - 1).astype(np.int64)
    else:
        ints = arr.astype(np.int64)

    out = bytearray(b"fLaC")
    # STREAMINFO (type 0, last metadata block), md5 zeroed = unverified.
    packed = (sample_rate << 44) | ((channels - 1) << 41) | (
        (bits_per_sample - 1) << 36
    ) | (n & ((1 << 36) - 1))
    streaminfo = (
        struct.pack(">HH", block_size, block_size)
        + b"\x00\x00\x00" * 2
        + packed.to_bytes(8, "big")
        + b"\x00" * 16
    )
    out += struct.pack(">I", (1 << 31) | (0 << 24) | len(streaminfo)) + streaminfo

    ss_code = {8: 1, 12: 2, 16: 4, 20: 5, 24: 6, 32: 7}[bits_per_sample]
    sr_code = {v: k for k, v in _SAMPLE_RATES.items()}.get(sample_rate)
    mid_side = stereo_mode == "mid-side"
    if mid_side and channels != 2:
        raise ValueError("mid-side needs exactly 2 channels")
    ch_code = 10 if mid_side else channels - 1

    for frame_idx, start in enumerate(range(0, n, block_size)):
        chunk = ints[:, start : start + block_size]
        m = chunk.shape[1]

        w = _BitWriter()
        w.write(0b11111111111110, 14)
        w.write(0, 1)  # reserved
        w.write(0, 1)  # fixed block-size strategy
        w.write(7, 4)  # block size: 16-bit field follows
        w.write(sr_code if sr_code else 13, 4)  # known code or 16-bit Hz
        w.write(ch_code, 4)
        w.write(ss_code, 3)
        w.write(0, 1)  # reserved
        for byte in _utf8_coded(frame_idx):
            w.write(byte, 8)
        w.write(m - 1, 16)
        if not sr_code:
            if sample_rate >= 1 << 16:
                raise ValueError(f"Cannot encode sample rate {sample_rate}")
            w.write(sample_rate, 16)
        header = bytes(w.buf)
        w.write(_crc8(header), 8)

        if mid_side:
            left, right = chunk[0], chunk[1]
            _encode_subframe(w, (left + right) >> 1, bits_per_sample)
            _encode_subframe(w, left - right, bits_per_sample + 1)
        else:
            for ch in range(channels):
                _encode_subframe(w, chunk[ch], bits_per_sample)
        w.align()
        frame_bytes = bytes(w.buf)
        w.write(_crc16(frame_bytes), 16)
        out += w.bytes()

    path = Path(path)
    path.write_bytes(bytes(out))
    return path
