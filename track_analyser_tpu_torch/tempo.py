"""Tempo estimation and beat tracking on the onset envelope (host, numpy).

The host finishers of the JAX package's ``tempo.py``: a float64
autocorrelation of the read-back envelope, band-masked argmax with
parabolic refinement, a least-squares onset regression for the grid, and
the DP beat tracker. ``onset_envelope``, ``estimate_bpm`` and
``beat_grid`` also compute the envelope itself, on the caller's device,
over the signal padded to the fused graph's bucket.

The beat grid is a ``dict[str, np.ndarray]`` with the columns of the JAX
package's ``pd.DataFrame`` (time, frame, bar, beat, is_downbeat): the
port does not depend on pandas.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from .config import DEFAULT_CONFIG
from .ops.peaks import onset_detect

DEFAULT_HOP_LENGTH = DEFAULT_CONFIG.hop_length
BEATS_PER_BAR = DEFAULT_CONFIG.beats_per_bar

__all__ = [
    "autocorrelate_host",
    "beat_grid",
    "estimate_bpm",
    "onset_envelope",
    "grid_and_bpm_from_env",
    "track_beats",
    "DEFAULT_HOP_LENGTH",
    "BEATS_PER_BAR",
]


def autocorrelate_host(env: np.ndarray) -> np.ndarray:
    """Linear autocorrelation of the onset envelope, float64 on host.

    The envelope is ~kB, so this costs microseconds, and doing it on host
    keeps the result independent of the device's FFT sizes and rounding:
    the beat regression downstream makes discrete decisions that would
    amplify that noise."""

    env = np.asarray(env, dtype=np.float64)
    n = env.size
    if n == 0:
        return np.zeros(1, dtype=float)
    n_fft = 1 << int(np.ceil(np.log2(max(2 * n - 1, 2))))
    spec = np.fft.rfft(env, n_fft)
    return np.fft.irfft(spec * np.conj(spec), n_fft)[:n]


def _bpm_from_autocorr(
    autocorr: np.ndarray, sr: int, hop_length: int, bpm_min: float, bpm_max: float
) -> float:
    if autocorr.size <= 1:
        return float(bpm_min)
    ac = autocorr[1:]  # discard zero-lag peak
    lags = np.arange(1, ac.size + 1, dtype=float)
    tempi = 60.0 * sr / (lags * hop_length)

    mask = (tempi >= bpm_min) & (tempi <= bpm_max)
    if not np.any(mask):
        mask = tempi > 0

    masked = ac[mask]
    scale = np.max(np.abs(masked))
    if scale > 0:
        masked = masked / scale
    masked_lags = lags[mask]
    peak_index = int(np.argmax(masked))

    refined_lag = masked_lags[peak_index]
    if 0 < peak_index < masked.size - 1:
        left, center, right = masked[peak_index - 1], masked[peak_index], masked[peak_index + 1]
        denominator = left - 2 * center + right
        if abs(denominator) > 1e-9:
            shift = 0.5 * (left - right) / denominator
            refined_lag = float(masked_lags[peak_index] + shift)

    refined_lag = max(refined_lag, 1.0)
    return float(60.0 * sr / (refined_lag * hop_length))


def _fit_onset_regression(
    onset_env: np.ndarray, sr: int, hop_length: int, beat_period: float
) -> Optional[Tuple[float, float]]:
    """Least-squares fit of onset times against rounded beat indices."""

    onset_frames = onset_detect(onset_env, sr, hop_length, backtrack=True)
    onset_times = onset_frames.astype(float) * hop_length / sr
    if onset_times.size < 4 or beat_period <= 0:
        return None

    indices = np.round(onset_times / beat_period).astype(int)
    mask = indices >= 0
    if not np.any(mask):
        return None

    unique: dict[int, float] = {}
    for idx, time in zip(indices[mask], onset_times[mask]):
        unique.setdefault(int(idx), float(time))
    if len(unique) < 4:
        return None

    sorted_indices = np.array(sorted(unique))
    times = np.array([unique[i] for i in sorted_indices])
    a_mat = np.vstack([np.ones_like(sorted_indices, dtype=float), sorted_indices]).T
    intercept, slope = np.linalg.lstsq(a_mat, times, rcond=None)[0]
    return float(intercept), float(slope)


def _initial_beat_time(onset_env: np.ndarray, sr: int, hop_length: int) -> Tuple[float, int]:
    onset_frames = onset_detect(onset_env, sr, hop_length, backtrack=True)
    if onset_frames.size == 0:
        return 0.0, 0
    first_frame = int(onset_frames[0])
    return float(first_frame * hop_length / sr), first_frame


def grid_and_bpm_from_env(
    env: np.ndarray,
    ac: "Optional[np.ndarray]",
    duration: float,
    sr: int,
    *,
    hop_length: int = DEFAULT_HOP_LENGTH,
    beats_per_bar: int = BEATS_PER_BAR,
) -> Tuple[Dict[str, np.ndarray], float]:
    """Host finisher: beat grid + BPM from a precomputed envelope.

    Pass ``ac=None`` (the normal case) to use the float64 host
    autocorrelation. The grid is a dict of equal-length columns: time,
    frame, bar, beat, is_downbeat.
    """

    if ac is None:
        ac = autocorrelate_host(env)
    bpm = _bpm_from_autocorr(ac, sr, hop_length, DEFAULT_CONFIG.bpm_min, DEFAULT_CONFIG.bpm_max)
    regression = _fit_onset_regression(env, sr, hop_length, 60.0 / bpm)
    if regression is not None:
        _, slope = regression
        if slope > 0:
            refined_bpm = 60.0 / slope
            if DEFAULT_CONFIG.bpm_min <= refined_bpm <= DEFAULT_CONFIG.bpm_max:
                bpm = float(refined_bpm)
    beat_period = 60.0 / bpm

    regression = _fit_onset_regression(env, sr, hop_length, beat_period)
    if regression is not None:
        start_time = max(regression[0], 0.0)
    else:
        start_time, _ = _initial_beat_time(env, sr, hop_length)
    if start_time < 0.0 or start_time > duration:
        start_time = 0.0

    total_beats = max(1, int(np.floor((duration - start_time) / beat_period)) + 1)
    times = start_time + np.arange(total_beats, dtype=float) * beat_period
    times = times[times <= duration + 1e-3]

    frames = np.floor(times * sr / hop_length).astype(int)
    beat_index = np.arange(times.size)
    bars = beat_index // beats_per_bar + 1
    beats = beat_index % beats_per_bar + 1

    grid = {
        "time": times,
        "frame": frames.astype(int),
        "bar": bars.astype(int),
        "beat": beats.astype(int),
        "is_downbeat": beats == 1,
    }
    return grid, float(bpm)


def track_beats(
    env: np.ndarray,
    sr: int,
    *,
    hop_length: int = DEFAULT_HOP_LENGTH,
    bpm: "Optional[float]" = None,
    tightness: float = 100.0,
    low_energy: "Optional[np.ndarray]" = None,
) -> np.ndarray:
    """Drift-following beat times via dynamic programming over the onset
    envelope (Ellis-style: onset strength plus the best predecessor score
    penalised by ``tightness * log^2(interval/period)``), vectorised in
    blocks of the minimum lag. ``low_energy``'s positive first difference
    (a kick-onset envelope) joins the evidence. Each beat then snaps to
    the nearest backtracked detected onset within 15% of a period.

    Returns beat times in seconds (possibly empty for degenerate input).
    """

    env = np.asarray(env, dtype=np.float64)
    n = env.size
    if n == 0 or not np.any(env > 0):
        return np.zeros(0)
    if bpm is None:
        bpm = _bpm_from_autocorr(
            autocorrelate_host(env), sr, hop_length,
            DEFAULT_CONFIG.bpm_min, DEFAULT_CONFIG.bpm_max,
        )
    period = 60.0 * sr / (hop_length * float(bpm))  # frames per beat
    e = env / (env.std() + 1e-12)
    if low_energy is not None and low_energy.size:
        low = np.asarray(low_energy, dtype=np.float64)[:n]
        low_flux = np.maximum(np.diff(low, prepend=low[:1]), 0.0)
        if np.any(low_flux > 0):
            e = e + low_flux / (low_flux.std() + 1e-12)

    lo = max(1, int(round(period / 2.0)))
    hi = min(n - 1, int(round(period * 2.0)))
    if hi <= lo:
        return np.zeros(0)
    deltas = np.arange(lo, hi + 1)
    txwt = -tightness * np.log(deltas / period) ** 2

    score = np.full(n, -np.inf)
    backlink = np.full(n, -1, dtype=np.int64)
    score[:lo] = e[:lo]
    # Frames [start, start+lo) depend only on frames before ``start``.
    for start in range(lo, n, lo):
        f = np.arange(start, min(start + lo, n))
        idx = f[:, None] - deltas[None, :]
        cand = np.where(idx >= 0, score[np.maximum(idx, 0)] + txwt[None, :], -np.inf)
        best = np.argmax(cand, axis=1)
        best_score = cand[np.arange(f.size), best]
        # a frame may also START the beat sequence (no predecessor)
        fresh = best_score < 0.0
        score[f] = e[f] + np.where(fresh, 0.0, best_score)
        backlink[f] = np.where(fresh, -1, f - deltas[best])

    # Last beat: the strongest cumulative score within the final period.
    tail_start = max(0, n - int(round(period * 1.2)))
    last = tail_start + int(np.argmax(score[tail_start:]))
    frames = []
    f = last
    while f >= 0:
        frames.append(f)
        f = int(backlink[f])
    frames = np.asarray(frames[::-1], dtype=np.float64)

    onset_frames = onset_detect(env, sr, hop_length, backtrack=True)
    if onset_frames.size:
        of = np.asarray(onset_frames, dtype=np.float64)
        pos = np.searchsorted(of, frames)
        left = of[np.clip(pos - 1, 0, of.size - 1)]
        right = of[np.clip(pos, 0, of.size - 1)]
        nearest = np.where(
            np.abs(frames - left) <= np.abs(right - frames), left, right
        )
        snap = np.abs(nearest - frames) <= 0.15 * period
        frames = np.where(snap, nearest, frames)
    return frames * hop_length / float(sr)


def _envelope_graph(y, *, sr: int, hop_length: int, n_fft: int = 2048, n_mels: int = 128):
    """Device portion: the onset envelope of ``y`` (a tensor on the
    device): |STFT|^2 -> mel -> spectral flux. The JAX package's graph
    also returns a device autocorrelation, which its per-module path
    discards for ``autocorrelate_host``; the port computes only the
    envelope."""

    from .ops.mel import mel_filterbank, melspectrogram_from_power
    from .ops.onset import onset_strength_from_mel
    from .ops.stft import magnitude

    power = magnitude(y, n_fft, hop_length, power=2.0)
    mel_power = melspectrogram_from_power(power, mel_filterbank(sr, n_fft, n_mels))
    return onset_strength_from_mel(mel_power, n_fft=n_fft, hop_length=hop_length)


def _padded_envelope(y: np.ndarray, sr: int, hop_length: int, device) -> np.ndarray:
    """Onset envelope over the bucket-padded signal, trimmed to the valid
    frames. Padding to the fused graph's bucket makes it the fused graph's
    envelope on one device: the beat regression makes discrete decisions,
    so shape-dependent float noise would fork the two paths' BPM."""

    import torch

    from .device import check_nans, resolve_device
    from .substrate import pad_to_bucket

    dev = resolve_device(device)
    padded, f_valid = pad_to_bucket(np.asarray(y, dtype=np.float32), hop=hop_length)
    with torch.inference_mode():
        env = check_nans(
            "tempo._envelope_graph", _envelope_graph(torch.from_numpy(padded).to(dev), sr=sr, hop_length=hop_length)
        )
    return env.cpu().numpy().astype(np.float64)[:f_valid]


def onset_envelope(
    y: np.ndarray, sr: int, hop_length: int = DEFAULT_HOP_LENGTH, *, device="cuda"
) -> np.ndarray:
    """Onset strength envelope (host view of the device result)."""

    env = _padded_envelope(y, sr, hop_length, device)
    if env.size == 0:
        return np.zeros(1, dtype=float)
    return env


def _envelope_and_autocorr(
    y: np.ndarray, sr: int, hop_length: int, device="cuda"
) -> Tuple[np.ndarray, np.ndarray]:
    env = _padded_envelope(y, sr, hop_length, device)
    if env.size == 0:
        return np.zeros(1, dtype=float), np.zeros(1, dtype=float)
    return env, autocorrelate_host(env)


def estimate_bpm(
    y: np.ndarray,
    sr: int,
    bpm_min: float = DEFAULT_CONFIG.bpm_min,
    bpm_max: float = DEFAULT_CONFIG.bpm_max,
    *,
    hop_length: int = DEFAULT_HOP_LENGTH,
    device="cuda",
) -> float:
    """Estimate tempo from autocorrelation of the onset strength envelope,
    refined by the onset regression's slope when it lies in the band."""

    env, ac = _envelope_and_autocorr(np.asarray(y, dtype=np.float32), sr, hop_length, device)
    if ac.size <= 1:
        return float(bpm_min)
    bpm = _bpm_from_autocorr(ac, sr, hop_length, bpm_min, bpm_max)

    regression = _fit_onset_regression(env, sr, hop_length, 60.0 / bpm)
    if regression is not None:
        _, slope = regression
        if slope > 0:
            refined_bpm = 60.0 / slope
            if bpm_min <= refined_bpm <= bpm_max:
                bpm = float(refined_bpm)
    return float(bpm)


def beat_grid(
    y: np.ndarray,
    sr: int,
    *,
    hop_length: int = DEFAULT_HOP_LENGTH,
    beats_per_bar: int = BEATS_PER_BAR,
    device: str = "cuda",
) -> Dict[str, np.ndarray]:
    """Constant-tempo beat grid annotated with bar positions (columns
    time, frame, bar, beat, is_downbeat)."""

    y = np.asarray(y, dtype=np.float32)
    env, ac = _envelope_and_autocorr(y, sr, hop_length, device)
    duration = len(y) / float(sr)
    grid, _ = grid_and_bpm_from_env(
        env, ac, duration, sr, hop_length=hop_length, beats_per_bar=beats_per_bar
    )
    return grid
