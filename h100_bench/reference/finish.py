"""The host's share of the answer: BS.1770 loudness, the tempo and beat
grid, and the compared fields assembled under the result's names.

Values the device ships at float32 (the onset envelope, the loudness
scalars, the spectrum) are rounded to float32 here too, and the two
curves it ships at 16 bits (novelty, centroid) to float16, as the
transport the results pass through does.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
from scipy import signal

from . import audio, graph
from .audio import HOP, N_FFT

BPM_MIN, BPM_MAX = 90.0, 135.0
BLOCK_S, SHORT_TERM_S = 0.4, 3.0

# -- loudness -------------------------------------------------------------------
def _biquad_k(fs: float):
    """BS.1770's two K-weighting stages (the high shelf, then the high
    pass) at ``fs``, from their analogue prototypes."""

    k = math.tan(math.pi * 1681.9744509555319 / fs)
    q = 0.7071752369554193
    vh = 10.0 ** (3.999843853973347 / 20.0)
    vb = vh ** 0.4996667741545416
    a0 = 1.0 + k / q + k * k
    shelf = ([(vh + vb * k / q + k * k) / a0, 2.0 * (k * k - vh) / a0, (vh - vb * k / q + k * k) / a0],
             [1.0, 2.0 * (k * k - 1.0) / a0, (1.0 - k / q + k * k) / a0])
    k = math.tan(math.pi * 38.13547087613982 / fs)
    q = 0.5003270373253953
    a0 = 1.0 + k / q + k * k
    high_pass = ([1.0, -2.0, 1.0], [1.0, 2.0 * (k * k - 1.0) / a0, (1.0 - k / q + k * k) / a0])
    return shelf, high_pass


def _chunk_energy(x: np.ndarray, hop: int, lead: int = 0) -> np.ndarray:
    """Sums of x^2 over consecutive ``hop``-sample chunks of x preceded by
    ``lead`` zeros (the last chunk zero-filled)."""

    padded = np.concatenate([np.zeros(lead), x, np.zeros(-(len(x) + lead) % hop)])
    return (padded.reshape(-1, hop) ** 2).sum(axis=1)


def integrated_lufs(y: np.ndarray, n: int, fs: int) -> float:
    """Gated loudness of the first ``n`` samples: 400 ms blocks every
    100 ms, an absolute gate at -70 LUFS, a relative one 10 LU under the
    mean of the blocks that pass it."""

    (b1, a1), (b2, a2) = _biquad_k(float(fs))
    yk = signal.lfilter(b2, a2, signal.lfilter(b1, a1, y[:n].astype(np.float64)))
    hop = int(round(BLOCK_S * 0.25 * fs))
    frame = int(round(BLOCK_S * fs))
    e = _chunk_energy(yk, hop)
    starts = np.arange(0, n - frame + 1, hop) // hop
    z = sum(e[starts + j] for j in range(frame // hop)) / frame
    loud = -0.691 + 10.0 * np.log10(z + 1e-20)
    kept = loud > -70.0
    z_abs = z[kept].sum() / max(kept.sum(), 1)
    kept &= loud > -0.691 + 10.0 * np.log10(z_abs + 1e-20) - 10.0
    return float(-0.691 + 10.0 * np.log10(z[kept].sum() / max(kept.sum(), 1) + 1e-20))


def _frame_hop(fs: int, seconds: float) -> Tuple[int, int]:
    frame = max(1024, int(round(fs * seconds)))
    frame += frame % 2
    return frame, frame // 2


def rms_db_curve(y: np.ndarray, n: int, fs: int, seconds: float) -> np.ndarray:
    """RMS in dB of centred frames of ``seconds`` (hop half a frame) over
    the padded signal, floored 80 dB under its loudest frame; the track's
    own frames ``1 + n // hop``."""

    frame, hop = _frame_hop(fs, seconds)
    e = _chunk_energy(y.astype(np.float64), hop, lead=hop)
    frames = 1 + len(y) // hop
    e = np.concatenate([e, np.zeros(max(0, frames + 1 - e.size))])
    energy = e[:frames] + e[1 : frames + 1]
    db = 10.0 * np.log10(np.maximum((np.sqrt(energy / frame) + 1e-9) ** 2, 1e-10))
    return np.maximum(db, db.max() - 80.0)[: 1 + n // hop]


# -- tempo and grid ---------------------------------------------------------------
def _onsets(env: np.ndarray, sr: int) -> np.ndarray:
    """Frames of the envelope's local peaks (the highest of the last three
    frames, at least 0.1 * max or 0.07 over its 0.1 s surround's mean,
    kept if more than 2 frames after the last kept one), each moved back
    to the local minimum at or before it."""

    if env.size == 0 or not env.any() or not np.isfinite(env).all():
        return np.zeros(0, dtype=int)
    delta = max(0.07, 0.1 * float(env.max()))
    pre_max, wait = int(0.03 * sr // HOP), int(0.03 * sr // HOP)
    pre_avg, post_avg = int(0.10 * sr // HOP), int(0.10 * sr // HOP + 1)
    n = env.size
    i = np.arange(n)
    lead = np.concatenate([np.full(pre_max, -np.inf), env])
    local_max = np.max([lead[i + k] for k in range(pre_max + 1)], axis=0)
    cs = np.concatenate([[0.0], np.cumsum(env)])
    lo, hi = np.maximum(0, i - pre_avg), np.minimum(n, i + post_avg)
    mean = (cs[hi] - cs[lo]) / np.maximum(hi - lo, 1)
    kept, last = [], -np.inf
    for f in np.flatnonzero((env == local_max) & (env >= mean + delta) & (env > 0)):
        if f > last + wait:
            kept.append(f)
            last = f
    if not kept:
        return np.zeros(0, dtype=int)
    minima = np.union1d([0], 1 + np.flatnonzero((env[1:-1] <= env[:-2]) & (env[1:-1] < env[2:])))
    at = np.clip(np.searchsorted(minima, kept, side="right") - 1, 0, minima.size - 1)
    return minima[at]


def _bpm_from_autocorrelation(env: np.ndarray, sr: int) -> float:
    n = env.size
    if n <= 1:
        return BPM_MIN
    size = 1 << int(math.ceil(math.log2(max(2 * n - 1, 2))))
    spec = np.fft.rfft(env, size)
    ac = np.fft.irfft(spec * np.conj(spec), size)[1:n]
    lags = np.arange(1, n, dtype=float)
    tempi = 60.0 * sr / (lags * HOP)
    band = (tempi >= BPM_MIN) & (tempi <= BPM_MAX)
    if not band.any():
        band = tempi > 0
    score, lag = ac[band], lags[band]
    top = np.max(np.abs(score))
    if top > 0:
        score = score / top
    k = int(np.argmax(score))
    best = lag[k]
    if 0 < k < score.size - 1:
        left, mid, right = score[k - 1], score[k], score[k + 1]
        curve = left - 2 * mid + right
        if abs(curve) > 1e-9:
            best = float(lag[k] + 0.5 * (left - right) / curve)
    return float(60.0 * sr / (max(best, 1.0) * HOP))


def _fit(times: np.ndarray, period: float) -> Optional[Tuple[float, float]]:
    """(intercept, slope) of the least-squares line through each beat
    index's first onset time, onsets numbered by rounding time / period."""

    if times.size < 4 or period <= 0:
        return None
    first: Dict[int, float] = {}
    for idx, t in zip(np.round(times / period).astype(int), times):
        if idx >= 0 and idx not in first:
            first[int(idx)] = float(t)
    if len(first) < 4:
        return None
    idx = np.array(sorted(first), dtype=float)
    a = np.stack([np.ones_like(idx), idx], axis=1)
    intercept, slope = np.linalg.lstsq(a, np.array([first[int(i)] for i in idx]), rcond=None)[0]
    return float(intercept), float(slope)


def beat_grid(env: np.ndarray, duration: float, sr: int) -> Tuple[float, np.ndarray]:
    """(bpm, beat times): the autocorrelation's tempo refined by the line
    through the onsets, and a constant grid from the line's intercept."""

    bpm = _bpm_from_autocorrelation(env, sr)
    onset_times = _onsets(env, sr).astype(float) * HOP / sr
    line = _fit(onset_times, 60.0 / bpm)
    if line is not None and line[1] > 0 and BPM_MIN <= 60.0 / line[1] <= BPM_MAX:
        bpm = 60.0 / line[1]
    period = 60.0 / bpm
    line = _fit(onset_times, period)
    if line is not None:
        start = max(line[0], 0.0)
    else:
        start = float(onset_times[0]) if onset_times.size else 0.0
    if start < 0.0 or start > duration:
        start = 0.0
    count = max(1, int(np.floor((duration - start) / period)) + 1)
    times = start + np.arange(count) * period
    return float(bpm), times[times <= duration + 1e-3]


def _grid_confidence(times: np.ndarray) -> float:
    gaps = np.diff(times)
    if gaps.size == 0:
        return 0.0
    if np.allclose(gaps, gaps[0]):
        return 1.0
    return float(np.clip(1.0 - np.std(gaps) / (np.mean(gaps) + 1e-9), 0.0, 1.0))


# -- the answer ------------------------------------------------------------------
def _f32(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32).astype(np.float64)


def _db20(x) -> float:
    return float(20.0 * np.log10(float(np.float32(x)) + 1e-12))


def analyse(path: str, *, device: str = "cpu", control: bool = False) -> dict:
    """The compared fields of the analysis of ``path``, as a nested dict
    under the result's field names. ``control`` computes the graph in
    float32 with TF32 (the precision control)."""

    d = audio.load(path)
    sr, n = d.sample_rate, d.n
    y = audio.mid_as_sent(d)
    out = graph.run(y, n, sr, device, control=control)
    exact = audio.stereo_exact(d)
    duration = n / float(sr)

    bpm, times = beat_grid(_f32(out["onset_env"]), duration, sr)
    momentary = _f32(rms_db_curve(y, n, sr, BLOCK_S))
    short_term = _f32(rms_db_curve(y, n, sr, SHORT_TERM_S))
    balance = _f32(out["balance"])
    total = float(np.float32(balance.sum()))
    shares = balance / total if total > 0 else np.zeros(3)
    return {
        "beat": {"bpm": bpm, "beat_times": times.tolist(), "confidence": _grid_confidence(times)},
        "loudness": {
            "integrated_lufs": float(np.float32(integrated_lufs(y, n, sr))),
            "short_term_lufs": short_term.tolist(),
            "momentary_lufs": momentary.tolist(),
            "loudness_range": float(np.percentile(momentary, 95) - np.percentile(momentary, 5)),
            "true_peak_dbfs": _db20(out["true_peak"]),
            "rms_dbfs": _db20(out["rms"]),
        },
        "structure": {"novelty_curve": out["novelty"].astype(np.float16).astype(np.float64).tolist()},
        "harmonic": {
            "spectral_balance": {"low_band": shares[0], "mid_band": shares[1], "high_band": shares[2]},
            "stereo_image": {"correlation": exact.correlation, "balance": exact.balance},
        },
        "features": {
            "ltas": {"frequencies": np.linspace(0.0, sr / 2.0, N_FFT // 2 + 1), "magnitude": _f32(out["ltas"])},
            "spectral_centroid": {"values": out["centroid"].astype(np.float16).astype(np.float64)},
        },
        "stereo": {
            "mid_rms": exact.mid_rms,
            "side_rms": exact.side_rms,
            "correlation": exact.correlation,
            "width": dict(zip(("low", "mid", "high"), exact.widths.tolist())),
        },
    }
