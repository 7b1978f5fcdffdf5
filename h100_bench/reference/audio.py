"""From a WAV file to the samples the fused graph sees, and the stereo
values the host works out exactly.

- the decode: 16-bit PCM over 32768, channel-major;
- the resample to the analysis rate, 44.1 kHz: scipy's polyphase
  ``resample_poly`` on float32 samples, rounded to float32;
- the "ms" transport: the mid channel ``(l + r) / 2`` in float32, padded
  with zeros to the track's bucket and cut into blocks of 65 536 samples,
  each sent as int8 codes ``rint(clip(x * (127 / peak), -127, 127))`` and
  its float32 peak, and read back as ``code * (peak / 127)``;
- the stereo sums in float64 over the source's channels (a mono file is
  one channel, read as left and right), and the per-band widths from a
  float64 STFT of at most 192 evenly strided frames.
"""

from __future__ import annotations

import math
import wave
from dataclasses import dataclass

import numpy as np
from scipy import signal

ANALYSIS_SR = 44_100
HOP = 512
N_FFT = 2048
BLOCK = 65_536  # samples a transport scale covers


@dataclass
class Decoded:
    """A file at the analysis rate: ``channels`` (C, n) float32 and the
    number of samples ``n`` the analysis counts."""

    channels: np.ndarray
    sample_rate: int

    @property
    def n(self) -> int:
        return int(self.channels.shape[-1])


def read_wav(path: str) -> "tuple[np.ndarray, int]":
    """(channels (C, n) float32 in [-1, 1), sample rate) of a 16-bit PCM WAV."""

    with wave.open(str(path), "rb") as f:
        if f.getsampwidth() != 2:
            raise ValueError(f"{path}: only 16-bit PCM is read here")
        c, sr = f.getnchannels(), f.getframerate()
        raw = np.frombuffer(f.readframes(f.getnframes()), dtype="<i2")
    pcm = raw[: raw.size // c * c].reshape(-1, c).T
    return np.ascontiguousarray(pcm, dtype=np.float32) / np.float32(32768.0), sr


def load(path: str) -> Decoded:
    x, sr = read_wav(path)
    if sr != ANALYSIS_SR:
        g = math.gcd(ANALYSIS_SR, sr)
        x = np.asarray(signal.resample_poly(x, ANALYSIS_SR // g, sr // g, axis=-1), dtype=np.float32)
    return Decoded(x[:2], ANALYSIS_SR)


def bucket_length(n: int) -> int:
    """The length the "ms" transport pads a track to: eight geometric steps
    an octave, in multiples of 65 536 samples, up to 2**21 samples; past
    that a tier of 4, 6, 8, 12, 16, 24 or 32 chunks of 2**21 samples
    (then multiples of 8 chunks)."""

    chunk = 1 << 21
    if n <= chunk:
        n = max(n, 1 << 15)
        step = int(np.ceil(2.0 ** (int(np.ceil(8.0 * np.log2(n))) / 8.0)))
        return -(-step // BLOCK) * BLOCK
    chunks = -(-n // chunk)
    tier = next((t for t in (4, 6, 8, 12, 16, 24, 32) if chunks <= t), -(-chunks // 8) * 8)
    return tier * chunk


def mid_as_sent(d: Decoded) -> np.ndarray:
    """The mid channel as the device reads it back, zero-padded to the
    bucket: float32, length ``bucket_length(n)``."""

    left, right = d.channels[0], d.channels[-1]
    padded = np.zeros(bucket_length(d.n), dtype=np.float32)
    padded[: d.n] = (left + right) * np.float32(0.5)
    blocks = padded.reshape(-1, BLOCK)
    peak = np.abs(blocks).max(axis=1)
    inv = np.float32(127.0) / np.where(peak > 0, peak, np.float32(1.0))
    codes = np.rint(np.clip(blocks * inv[:, None], np.float32(-127.0), np.float32(127.0))).astype(np.int8)
    step = peak / np.float32(127.0)
    return (codes.astype(np.float32) * step[:, None]).reshape(-1)


@dataclass
class StereoExact:
    mid_rms: float
    side_rms: float
    correlation: float
    balance: float
    widths: np.ndarray  # low (0-200 Hz), mid (200-2000 Hz), high (2 kHz - Nyquist)


def stereo_exact(d: Decoded) -> StereoExact:
    left = d.channels[0].astype(np.float64)
    right = d.channels[-1].astype(np.float64)
    n = max(float(d.n), 1.0)
    sl, sr_ = left.sum(), right.sum()
    ll, rr, lr = left @ left, right @ right, left @ right
    lc2 = max(ll - sl * sl / n, 0.0)
    rc2 = max(rr - sr_ * sr_ / n, 0.0)
    denom = math.sqrt(lc2) * math.sqrt(rc2)
    corr = 1.0 if denom <= 1e-12 else float(np.clip((lr - sl * sr_ / n) / denom, -1.0, 1.0))
    return StereoExact(
        mid_rms=math.sqrt(max(ll + 2 * lr + rr, 0.0) / (4.0 * n)),
        side_rms=math.sqrt(max(ll - 2 * lr + rr, 0.0) / (4.0 * n)),
        correlation=corr,
        balance=float(np.abs(left).sum() / n - np.abs(right).sum() / n),
        widths=_band_widths(left, right, d.sample_rate),
    )


def hann(n: int) -> np.ndarray:
    """The periodic Hann window, as float32 values."""

    return (0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / n)).astype(np.float32)


def _band_widths(left: np.ndarray, right: np.ndarray, sr: int, max_frames: int = 192) -> np.ndarray:
    """sqrt(side energy / mid energy) in three bands, from centred Hann
    frames (zeros outside the signal) taken every ``ceil(frames / 192)``."""

    n = left.size
    frames = 1 + n // HOP
    starts = np.arange(0, frames, -(-frames // max_frames)) * HOP - N_FFT // 2
    out = np.zeros(3)
    mid_e = np.zeros((starts.size, N_FFT // 2 + 1))
    side_e = np.zeros_like(mid_e)
    win = hann(N_FFT).astype(np.float64)
    for k, s in enumerate(starts):
        lo, hi = max(s, 0), min(s + N_FFT, n)
        fl, fr = np.zeros(N_FFT), np.zeros(N_FFT)
        fl[lo - s : hi - s] = left[lo:hi]
        fr[lo - s : hi - s] = right[lo:hi]
        mid_e[k] = np.abs(np.fft.rfft(0.5 * (fl + fr) * win)) ** 2
        side_e[k] = np.abs(np.fft.rfft(0.5 * (fl - fr) * win)) ** 2
    freqs = np.linspace(0.0, sr / 2.0, N_FFT // 2 + 1)
    nyq = sr / 2.0
    for b, (lo_f, hi_f) in enumerate(((0.0, min(200.0, nyq)), (200.0, min(2000.0, nyq)), (2000.0, nyq))):
        band = (freqs >= lo_f) & (freqs <= hi_f)
        m, s = mid_e[:, band].mean(), side_e[:, band].mean()
        out[b] = 0.0 if m <= 1e-12 else math.sqrt(s / m)
    return out
