"""A second music engine, vectorised: wavetable oscillators, linear ADSR,
resonant-biquad percussion, a formant "vocal" and a Schroeder reverb.

A copy of the repository's ``scripts/independent_engine.py`` (its
``render_random_song``), rewritten so that no filter loops in Python per
sample: the biquads run through ``scipy.signal.lfilter``, and the
reverb's combs and allpasses, whose delays are hundreds of samples, run
one delay-length block at a time. The draws from the generator are the
original's, in its order; the arithmetic of the filters is the same
recursion, rounded in another order. ``seconds`` renders enough bars to
fill that length and cuts the mix to it.
"""

from __future__ import annotations

import math

import numpy as np
from scipy.signal import lfilter

TABLE_LEN = 2048


def _wavetable(kind: str) -> np.ndarray:
    k = np.arange(1, 25, dtype=np.float64)
    phase = np.linspace(0.0, 1.0, TABLE_LEN, endpoint=False)
    if kind == "saw":
        weights = 1.0 / k
        signs = np.where(k % 2 == 0, -1.0, 1.0)
    elif kind == "square":
        weights = np.where(k % 2 == 1, 1.0 / k, 0.0)
        signs = np.ones_like(k)
    elif kind == "triangle":
        weights = np.where(k % 2 == 1, 1.0 / k**2, 0.0)
        signs = np.where(((k - 1) // 2) % 2 == 0, 1.0, -1.0)
    else:  # organ: fundamental + octaves
        weights = np.where(np.isin(k, (1, 2, 4, 8)), 1.0 / np.sqrt(k), 0.0)
        signs = np.ones_like(k)
    table = (signs * weights) @ np.sin(2.0 * np.pi * k[:, None] * phase[None, :])
    return table / np.max(np.abs(table))


_TABLES = {kind: _wavetable(kind) for kind in ("saw", "square", "triangle", "organ")}


def osc(kind: str, freq_hz, n: int, sr: int, phase0: float = 0.0) -> np.ndarray:
    """Phase-accumulator wavetable oscillator, linear interpolation."""

    freq = np.broadcast_to(np.asarray(freq_hz, dtype=np.float64), (n,))
    phase = (phase0 + np.cumsum(freq) / sr) % 1.0
    x = phase * TABLE_LEN
    i0 = x.astype(np.int64) % TABLE_LEN
    frac = x - np.floor(x)
    table = _TABLES[kind]
    return table[i0] * (1.0 - frac) + table[(i0 + 1) % TABLE_LEN] * frac


def adsr(n: int, sr: int, a: float, d: float, s_level: float, r: float) -> np.ndarray:
    na, nd, nr = (max(1, int(t * sr)) for t in (a, d, r))
    ns = max(0, n - na - nd - nr)
    env = np.concatenate([
        np.linspace(0.0, 1.0, na, endpoint=False),
        np.linspace(1.0, s_level, nd, endpoint=False),
        np.full(ns, s_level),
        np.linspace(s_level, 0.0, nr, endpoint=False),
    ])
    return env[:n] if env.size >= n else np.pad(env, (0, n - env.size))


def biquad(x: np.ndarray, b: tuple, a: tuple) -> np.ndarray:
    """Direct-form biquad with a0-normalised coefficients."""

    return lfilter(np.asarray(b, dtype=np.float64), np.array([1.0, a[0], a[1]]), x)


def _rbj_bandpass(fc: float, q: float, sr: int) -> tuple:
    w0 = 2.0 * np.pi * fc / sr
    alpha = np.sin(w0) / (2.0 * q)
    a0 = 1.0 + alpha
    return (alpha / a0, 0.0, -alpha / a0), ((-2.0 * np.cos(w0)) / a0, (1.0 - alpha) / a0)


def _rbj_lowpass(fc: float, q: float, sr: int) -> tuple:
    w0 = 2.0 * np.pi * fc / sr
    alpha = np.sin(w0) / (2.0 * q)
    cw = np.cos(w0)
    a0 = 1.0 + alpha
    return (
        ((1 - cw) / 2 / a0, (1 - cw) / a0, (1 - cw) / 2 / a0),
        (-2 * cw / a0, (1 - alpha) / a0),
    )


def resonant_drum(kind: str, n: int, sr: int, rng: np.random.Generator) -> np.ndarray:
    if kind == "kick":
        exc = np.zeros(n)
        exc[0] = 1.0
        exc[: int(0.004 * sr)] += rng.normal(0, 0.2, int(0.004 * sr))
        y = biquad(exc, *_rbj_bandpass(55.0, 1.2, sr))
        y += 0.6 * biquad(exc, *_rbj_bandpass(90.0, 0.9, sr))
        y *= adsr(n, sr, 0.001, 0.05, 0.25, 0.18)
    elif kind == "snare":
        exc = rng.normal(0, 1.0, n) * adsr(n, sr, 0.001, 0.03, 0.1, 0.09)
        y = biquad(exc, *_rbj_bandpass(190.0, 1.5, sr))
        y += 0.8 * biquad(exc, *_rbj_bandpass(1800.0, 0.7, sr))
    else:  # hat
        exc = rng.normal(0, 1.0, n) * adsr(n, sr, 0.0005, 0.012, 0.05, 0.03)
        y = biquad(exc, *_rbj_bandpass(7000.0, 1.1, sr))
    peak = np.max(np.abs(y)) or 1.0
    return y / peak


_FORMANTS = {
    "a": ((800, 9.0), (1150, 11.0), (2900, 13.0)),
    "i": ((280, 9.0), (2250, 12.0), (2900, 14.0)),
    "o": ((450, 9.0), (800, 10.0), (2830, 13.0)),
    "e": ((400, 9.0), (1600, 12.0), (2700, 13.0)),
}


def vocal_phrase(f0_hz: np.ndarray, n: int, sr: int, vowels: list) -> np.ndarray:
    """Glottal-style pulse train through cascaded formant biquads, 5.5 Hz
    vibrato."""

    vib = 1.0 + 0.012 * osc("triangle", 5.5, n, sr)
    freq = np.broadcast_to(np.asarray(f0_hz, dtype=np.float64), (n,)) * vib
    frac = (np.cumsum(freq) / sr) % 1.0
    pulse = np.where(frac < 0.35, 0.5 - 0.5 * np.cos(2 * np.pi * frac / 0.35), 0.0)
    pulse = np.diff(pulse, prepend=0.0)
    seg_len = n // max(1, len(vowels))
    y = np.zeros(n)
    for vi, vowel in enumerate(vowels):
        s, e = vi * seg_len, min(n, (vi + 1) * seg_len)
        seg = pulse[s:e]
        acc = sum(biquad(seg, *_rbj_bandpass(fc, q, sr)) for fc, q in _FORMANTS[vowel])
        y[s:e] = acc * adsr(e - s, sr, 0.04, 0.1, 0.8, 0.12)
    peak = np.max(np.abs(y)) or 1.0
    return y / peak


def _feedback(x: np.ndarray, d: int, g: float) -> np.ndarray:
    """y[i] = x[i] + g * y[i - d] (y = x before the first delay), one
    block of ``d`` samples at a time."""

    y = x.copy()
    for s in range(d, y.size, d):
        e = min(s + d, y.size)
        y[s:e] += g * y[s - d : e - d]
    return y


def comb(x: np.ndarray, delay_s: float, fb: float, sr: int) -> np.ndarray:
    return _feedback(x, max(1, int(delay_s * sr)), fb)


def allpass(x: np.ndarray, delay_s: float, g: float, sr: int) -> np.ndarray:
    """The original's ring-buffer allpass: w = x + g * w[-d] (the buffer),
    out = -g * x + w[-d]."""

    d = max(1, int(delay_s * sr))
    w = _feedback(x, d, g)
    out = -g * x
    out[d:] += w[:-d]
    return out


def schroeder_reverb(x: np.ndarray, sr: int, wet: float = 0.12) -> np.ndarray:
    tail = sum(comb(x, ds, 0.72, sr) for ds in (0.0297, 0.0371, 0.0411, 0.0437)) / 4.0
    tail = allpass(allpass(tail, 0.005, 0.7, sr), 0.0017, 0.7, sr)
    return (1.0 - wet) * x + wet * tail


_WALKS = [
    ([0, -4, 3, -2], ["min", "maj", "maj", "maj"]),
    ([0, 5, 7, 5], ["maj", "maj", "maj", "maj"]),
    ([0, -3, 5, 7], ["min", "maj", "maj", "maj"]),
    ([0, 7, -4, 5], ["maj", "maj", "min", "maj"]),
]


def render_random_song(seed: int, sr: int = 22_050, seconds: float = 30.0) -> np.ndarray:
    """A randomised four-stem song, mixed and reverberated, cut to
    ``seconds``: key, tempo, meter (3 or 4) and arrangement drawn from
    ``seed``. Returns the mono mix, float32, peak 0.9."""

    rng = np.random.default_rng(seed)
    bpm = float(rng.uniform(92.0, 132.0))
    meter = int(rng.choice([3, 4]))
    transpose = int(rng.integers(-5, 7))
    tf = 2.0 ** (transpose / 12.0)
    beat_s = 60.0 / bpm
    bars = math.ceil(seconds / (meter * beat_s))
    n = int(bars * meter * beat_s * sr) + int(0.5 * sr)
    beat_times = np.arange(bars * meter) * beat_s

    drums = np.zeros(n)
    kick = resonant_drum("kick", int(0.25 * sr), sr, rng)
    snare = resonant_drum("snare", int(0.18 * sr), sr, rng)
    hat = resonant_drum("hat", int(0.06 * sr), sr, rng)
    snare_beats = {4: (1, 3), 3: ((1,) if rng.random() < 0.5 else (1, 2))}[meter]
    hat_eighths = bool(rng.random() < 0.4)
    kick_g = float(rng.uniform(0.8, 1.0))
    snare_g = float(rng.uniform(0.4, 0.6))
    hat_g = float(rng.uniform(0.3, 0.5))
    for bi, t in enumerate(beat_times):
        s = int(t * sr)
        drums[s : s + kick.size] += kick_g * kick[: n - s]
        if bi % meter in snare_beats:
            drums[s : s + snare.size] += snare_g * snare[: n - s]
        for off in (0.25, 0.5, 0.75) if hat_eighths else (0.5,):
            hs = int((t + off * beat_s) * sr)
            if hs < n:
                drums[hs : hs + hat.size] += hat_g * hat[: n - hs]

    walk_deg, walk_qual = _WALKS[int(rng.integers(0, len(_WALKS)))]
    root_hz = 55.0 * tf

    bass = np.zeros(n)
    bass_wave = str(rng.choice(["square", "saw", "triangle"]))
    lowpass = _rbj_lowpass(400.0 * tf, 0.8, sr)
    for bar in range(bars):
        f = root_hz * 2.0 ** (walk_deg[bar % 4] / 12.0)
        for bi in range(meter):
            s = int((bar * meter + bi) * beat_s * sr)
            if s >= n:
                break
            note = osc(bass_wave, f, min(int(0.9 * beat_s * sr), n - s), sr)
            note = biquad(note, *lowpass)
            bass[s : s + note.size] += note * adsr(note.size, sr, 0.004, 0.08, 0.55, 0.1)

    def chord_freqs(deg: int, qual: str) -> tuple:
        base = 220.0 * tf * 2.0 ** (deg / 12.0)
        return (base, base * 2.0 ** ((3 if qual == "min" else 4) / 12.0), base * 2.0 ** (7 / 12.0))

    other = np.zeros(n)
    comp_style = str(rng.choice(["ands", "beats", "pad"]))
    chord_wave = str(rng.choice(["saw", "organ"]))
    for bar in range(bars):
        freqs = chord_freqs(walk_deg[bar % 4], walk_qual[bar % 4])
        if comp_style == "pad":
            s = int(bar * meter * beat_s * sr)
            if s >= n:
                break
            dur = min(int(meter * beat_s * sr), n - s)
            pad = sum(osc(chord_wave, f, dur, sr, phase0=0.13 * i) for i, f in enumerate(freqs))
            other[s : s + dur] += 0.28 * pad * adsr(dur, sr, 0.05, 0.2, 0.7, 0.3)
        else:
            offs = [b + 0.5 for b in range(meter)] if comp_style == "ands" else list(range(meter))
            for off in offs:
                s = int((bar * meter + off) * beat_s * sr)
                if s >= n:
                    break
                dur = min(int(0.45 * beat_s * sr), n - s)
                stab = sum(osc(chord_wave, f, dur, sr, phase0=0.13 * i) for i, f in enumerate(freqs))
                other[s : s + dur] += 0.33 * stab * adsr(dur, sr, 0.01, 0.1, 0.4, 0.12)

    vocals = np.zeros(n)
    has_vocals = bool(rng.random() < 0.7)
    if has_vocals:
        mel_deg = [0, 2, 3, 0] if walk_qual[0] == "min" else [0, 2, 4, 0]
        melody = [220.0 * tf * 2.0 ** (d / 12.0) for d in mel_deg]
        for bar in range(0, bars - 1, 4):
            s = int(bar * meter * beat_s * sr)
            dur = int(2 * meter * beat_s * sr)
            if s + dur > n:
                break
            f0 = np.concatenate(
                [np.full(dur // len(melody), f) for f in melody] + [np.full(dur - 4 * (dur // 4), melody[-1])]
            )[:dur]
            vocals[s : s + dur] += vocal_phrase(f0, dur, sr, ["a", "i", "o", "e"])

    stems = (
        0.9 * drums,
        float(rng.uniform(0.4, 0.6)) * bass / (np.max(np.abs(bass)) or 1.0),
        float(rng.uniform(0.35, 0.55)) * other / (np.max(np.abs(other)) or 1.0),
        (0.5 * vocals / (np.max(np.abs(vocals)) or 1.0)) if has_vocals else vocals,
    )
    mix = schroeder_reverb(sum(stems), sr, wet=float(rng.uniform(0.06, 0.16)))
    mix = mix[: int(round(seconds * sr))]
    peak = np.max(np.abs(mix)) or 1.0
    return (mix * (0.9 / peak)).astype(np.float32)
