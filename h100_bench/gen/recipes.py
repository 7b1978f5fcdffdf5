"""The two club-music recipes of the repository's ``bench.py``, in numpy.

``club`` is ``bench.py``'s ``_make_track`` (kick on every beat, off-beat
hats, a gated 55 Hz bass, a sustained triad, stereo by gains) and
``sparse_minor`` its ``_make_sparse_minor`` (minor-triad pads moving
every two bars, a soft kick every other beat). Both take the tempo and a
transposition in semitones, so that a seed can vary the key, and return
channel-major (2, n) float32 at peak 0.9 without importing anything of
the analyser. The sinusoids are built by block rotation (``tone``): the
same values as ``np.sin`` to ~1e-12, at a few multiply-adds a sample.
"""

from __future__ import annotations

import numpy as np


def tone(freq_hz: float, n: int, sr: int, block: int = 4096) -> np.ndarray:
    """sin(2 pi f i / sr) for i < n, as sin(a + b) = sin a cos b + cos a sin b
    over blocks of ``block`` samples (a the block's start, b the offset)."""

    w = 2.0 * np.pi * freq_hz / sr
    starts = w * block * np.arange(-(-n // block))
    offsets = w * np.arange(block)
    out = np.multiply.outer(np.sin(starts), np.cos(offsets))
    out += np.multiply.outer(np.cos(starts), np.sin(offsets))
    return out.reshape(-1)[:n]


def _kick(n: int, sr: int, starts: np.ndarray, length_s: float, f0: float, sweep: float,
          sweep_rate: float, decay: float, gain: float) -> np.ndarray:
    """Sine-sweep kicks at sample offsets ``starts``, summed into (n,)."""

    out = np.zeros(n)
    seg = np.arange(int(length_s * sr)) / sr
    hit = gain * np.sin(2 * np.pi * (f0 + sweep * np.exp(-seg * sweep_rate)) * seg) * np.exp(-seg * decay)
    for s in starts:
        e = min(n, s + hit.size)
        out[s:e] += hit[: e - s]
    return out


def club(seconds: float, sr: int, bpm: float, transpose: int, rng: np.random.Generator) -> np.ndarray:
    """Club-style stereo track: kick grid, off-beat noise hats, bass, triad."""

    n = int(seconds * sr)
    tf = 2.0 ** (transpose / 12.0)
    beat = 60.0 / bpm
    beats = np.arange(0.0, seconds, beat)
    kick = _kick(n, sr, (beats * sr).astype(np.int64), 0.08, 60.0, 40.0, 60.0, 30.0, 1.0)
    hat = np.zeros(n)
    hat_len = int(0.02 * sr)
    hat_env = np.exp(-np.arange(hat_len) / (0.004 * sr))
    for b in beats:
        hs = int((b + beat / 2) * sr)
        he = min(n, hs + hat_len)
        if he > hs:
            hat[hs:he] += rng.normal(0, 0.15, he - hs) * hat_env[: he - hs]
    bass = tone(55.0 * tf, n, sr)
    bass *= 0.2 * (tone(1.0 / 8.0, n, sr) > 0)
    chords = tone(220.0 * tf, n, sr)
    chords += tone(277.18 * tf, n, sr)
    chords += tone(329.63 * tf, n, sr)
    chords *= 0.1
    common = bass
    common += 0.8 * kick
    left = common + chords + 0.6 * hat
    common += 0.9 * chords
    common += 0.5 * hat
    return _normalise(left, common)


def sparse_minor(seconds: float, sr: int, bpm: float, transpose: int, rng: np.random.Generator) -> np.ndarray:
    """Minor pads (i, iv, v, i; two bars each) with a soft kick every other
    beat: bass-heavy minor content with weak onsets."""

    del rng  # deterministic given tempo and key, as the original
    n = int(seconds * sr)
    tf = 2.0 ** (transpose / 12.0)
    beat = 60.0 / bpm
    minor3, p5 = 2 ** (3 / 12), 2 ** (7 / 12)

    def triad(root_hz: float) -> np.ndarray:
        r = root_hz * tf
        out = tone(r, n, sr)
        out += 0.8 * tone(r * minor3, n, sr)
        out += 0.7 * tone(r * p5, n, sr)
        return out

    bar = 8 * beat
    phase = ((np.arange(n, dtype=np.float64) / sr) % (4 * bar)) / bar
    pads = triad(110.0)
    for lo, root in ((1.0, 146.83), (2.0, 164.81)):
        sel = (phase >= lo) & (phase < lo + 1.0)
        pads[sel] = triad(root)[sel]
    starts = (np.arange(0.0, seconds, beat)[::2] * sr).astype(np.int64)
    kick = _kick(n, sr, starts, 0.04, 55.0, 45.0, 70.0, 45.0, 0.5)
    return _normalise(0.35 * pads + kick, 0.3 * pads + kick)


def _normalise(left: np.ndarray, right: np.ndarray) -> np.ndarray:
    peak = max(np.abs(left).max(), np.abs(right).max()) or 1.0
    out = np.empty((2, left.size), dtype=np.float32)
    np.multiply(left, 0.9 / peak, out=out[0], casting="same_kind")
    np.multiply(right, 0.9 / peak, out=out[1], casting="same_kind")
    return out


RECIPES = {"club": club, "sparse_minor": sparse_minor}
