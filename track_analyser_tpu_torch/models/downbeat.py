"""Downbeat tracking: accent curves on the device, decoding on the host.

A meter/phase decoder over {3, 4} beats per bar: per-beat accent
evidence (linear mel energy, low-band energy, spectral flux, the
harmonic-change cue and, when the activation net ran, its P(downbeat))
is decoded by a bar-position Viterbi per meter. The fused path reads
the accent curves from the fused graph; ``track_downbeats`` (the
per-module path) computes them with ``_accent_graph`` on the caller's
device, as the JAX package's ``models/downbeat.py`` does.

The ladder: fewer than 4 beats gives None (the caller falls back to the
every-4th-beat heuristic), and without a checkpoint the accent features
decide alone. Any other error propagates; the JAX package swallows
every exception at these steps.

The trained checkpoints are the JAX package's bundled files, read from
``track_analyser_tpu/models/checkpoints`` as data (nothing is imported
from that package), in the same preference order and with the same
environment override.
"""

from __future__ import annotations

import os
import warnings
from dataclasses import dataclass
from pathlib import Path
from typing import List

import numpy as np
import torch

__all__ = ["available", "track_downbeats", "decode_from_accent", "DownbeatTrackingResult"]

_HOP = 512
_N_FFT = 2048


@dataclass(slots=True)
class DownbeatTrackingResult:
    downbeat_times: List[float]
    beat_positions: List[int]
    source: str


def available() -> bool:
    return True


_CKPT_DIR = Path(__file__).resolve().parents[2] / "track_analyser_tpu" / "models" / "checkpoints"
# Preference order: the newest time-parallel TCN, then the older TCN,
# then the GRU (which the fused path refuses).
_DEFAULT_CKPTS = (
    _CKPT_DIR / "downbeat_tcn_v2.npz",
    _CKPT_DIR / "downbeat_tcn_v1.npz",
    _CKPT_DIR / "downbeat_v1.npz",
)
_CKPT_ENV = "TRACK_ANALYSER_TPU_DOWNBEAT_CKPT"
_net_params_cache: dict = {}


def _net_params():
    """Trained activation-net weights (numpy): env override, then the
    bundled checkpoints (TCN preferred), else None (accent features
    only). A checkpoint that fails to load counts as absent."""

    from .downbeat_net import load_checkpoint

    path = os.environ.get(_CKPT_ENV) or next(
        (str(p) for p in _DEFAULT_CKPTS if p.exists()), None
    )
    if path is None:
        return None
    if path not in _net_params_cache:
        try:
            _net_params_cache[path] = load_checkpoint(path)
        except (OSError, ValueError, KeyError) as exc:
            warnings.warn(f"downbeat checkpoint {path} not loaded: {exc}")
            _net_params_cache[path] = None
    return _net_params_cache[path]


def _accent_graph(y: torch.Tensor, *, sr: int) -> tuple:
    """Per-frame accent curves of ``y`` (a tensor on the device): linear
    mel energy, low-band (< 150 Hz) energy and mean positive dB flux."""

    from ..ops.mel import mel_filterbank, melspectrogram_from_power, power_to_db
    from ..ops.stft import magnitude

    power = magnitude(y, _N_FFT, _HOP, power=2.0)
    mel_power = melspectrogram_from_power(power, mel_filterbank(sr, _N_FFT, 128))
    energy = torch.sqrt(mel_power.sum(dim=-2) + 1e-12)
    n_low = max(2, int(150.0 * _N_FFT / sr))
    low = torch.sqrt(power[..., :n_low, :].sum(dim=-2) + 1e-12)
    mel_db = power_to_db(mel_power, dims=(-2, -1))
    flux = torch.clamp_min(mel_db[..., 1:] - mel_db[..., :-1], 0.0).mean(dim=-2)
    flux = torch.nn.functional.pad(flux, (1, 0))
    return energy, low, flux


def _accent_curves(samples: np.ndarray, sample_rate: int, device) -> tuple:
    """(energy, low, flux) float64 of ``samples`` padded to its bucket and
    trimmed to the valid frames (the dB floor of the flux sits below the
    global maximum, which quiet padding cannot raise)."""

    from ..device import check_nans, resolve_device
    from ..substrate import pad_to_bucket

    dev = resolve_device(device)
    padded, f_valid = pad_to_bucket(np.asarray(samples, dtype=np.float32), hop=_HOP)
    with torch.inference_mode():
        curves = check_nans(
            "models.downbeat._accent_graph", _accent_graph(torch.from_numpy(padded).to(dev), sr=sample_rate)
        )
    return tuple(c.cpu().numpy().astype(np.float64)[:f_valid] for c in curves)


def track_downbeats(
    samples: np.ndarray,
    sample_rate: int,
    beat_times: "np.ndarray | List[float]",
    *,
    seed: int = 0,
    device="cuda",
) -> "DownbeatTrackingResult | None":
    """Pick the downbeat phase/meter that maximises accent contrast, on
    the accent curves, the net's P(downbeat) (when a checkpoint is
    bundled or named) and the harmonic-change cue; None for fewer than 4
    beats."""

    del seed  # deterministic model, kept for interface parity
    beat_times = np.asarray(beat_times, dtype=float)
    if beat_times.size < 4:
        return None

    from ..harmony import _compute_chromas
    from . import downbeat_net

    y = np.asarray(samples, dtype=np.float32)
    energy, low, flux = _accent_curves(y, sample_rate, device)
    params = _net_params()
    net_prob = None
    if params is not None:
        net_prob = downbeat_net.downbeat_activation(params, y, sample_rate, device=device)
    chroma, _ = _compute_chromas(y, sample_rate, device=device)
    return decode_from_accent(
        energy,
        low,
        beat_times,
        sample_rate,
        flux=flux,
        net_prob=net_prob,
        chroma=chroma,
    )


def _viterbi_positions(accent: np.ndarray, meter: int) -> tuple[float, np.ndarray]:
    """Bar-position Viterbi for one meter; returns (score, 1-based
    positions).

    States are positions 0..meter-1 (0 = downbeat). Emissions: position 0
    scores +accent, others -accent/(meter-1). Transitions advance one
    position per beat; staying or double-advancing (a missed/inserted
    beat) costs a fixed penalty, so the decoder can re-lock after grid
    slips.
    """

    slip_penalty = 10.0
    n = accent.size
    accent = np.asarray(accent, dtype=np.float64)
    emissions = np.full((n, meter), -1.0 / (meter - 1)) * accent[:, None]
    emissions[:, 0] = accent

    delta = emissions[0].copy()
    choices = np.empty((n - 1, meter), dtype=np.int8)
    for i in range(1, n):
        adv = np.roll(delta, 1)  # from position p-1
        stay = delta - slip_penalty
        skip = np.roll(delta, 2) - slip_penalty
        stacked = np.stack([adv, stay, skip])
        choices[i - 1] = np.argmax(stacked, axis=0)
        delta = stacked.max(axis=0) + emissions[i]

    state = int(np.argmax(delta))
    score = float(delta[state]) / max(n, 1)
    positions = np.zeros(n, dtype=int)
    positions[-1] = state
    for i in range(n - 2, -1, -1):
        move = choices[i, state]
        if move == 0:
            state = (state - 1) % meter
        elif move == 2:
            state = (state - 2) % meter
        positions[i] = state
    return score, positions + 1


def _zscore(x: np.ndarray) -> np.ndarray:
    std = float(np.std(x))
    if std < 1e-12:
        return np.zeros_like(x)
    return (x - np.mean(x)) / std


def _harmonic_change_cue(
    chroma: np.ndarray, beat_frames: np.ndarray, n_frames: int
) -> np.ndarray:
    """Per-beat harmonic-change evidence: 1 - cosine similarity between
    the mean chroma of the spans before and after each beat, normalised
    with an absolute floor so harmonically static material contributes
    ~nothing. Weight 3.0 lets clear harmonic rhythm out-vote the net."""

    cs = np.concatenate(
        [np.zeros((chroma.shape[0], 1)), np.cumsum(chroma, axis=1)], axis=1
    )
    hi = min(n_frames, cs.shape[1] - 1)
    bounds = np.concatenate([[0], np.clip(beat_frames, 0, hi), [hi]])
    bounds = np.maximum.accumulate(bounds)
    sums = cs[:, bounds[1:]] - cs[:, bounds[:-1]]  # (12, n_beats+1) span sums
    norms = np.linalg.norm(sums, axis=0)
    safe = np.where(norms > 1e-12, norms, 1.0)
    unit = sums / safe
    change = 1.0 - np.sum(unit[:, :-1] * unit[:, 1:], axis=0)
    change = np.where((norms[:-1] > 1e-12) & (norms[1:] > 1e-12), change, 0.0)
    centred = change - np.mean(change)
    return 3.0 * centred / (np.std(centred) + 0.05)


def decode_from_accent(
    energy: np.ndarray,
    low: np.ndarray,
    beat_times: np.ndarray,
    sample_rate: int,
    *,
    flux: "np.ndarray | None" = None,
    net_prob: "np.ndarray | None" = None,
    chroma: "np.ndarray | None" = None,
) -> "DownbeatTrackingResult | None":
    """Host decoder over precomputed accent curves. With the net's
    per-frame P(downbeat) the result is tagged source="rnn"; ``chroma``
    (12, n_frames) adds the harmonic-change cue."""

    beat_times = np.asarray(beat_times, dtype=float)
    if beat_times.size < 4:
        return None
    n_frames = energy.size
    if n_frames == 0:
        return None

    beat_frames = np.clip(
        np.floor(beat_times * sample_rate / _HOP).astype(int), 0, n_frames - 1
    )
    # Per-beat features: max over frames [f, f+2] absorbs the frame
    # quantisation of the grid.
    idx = np.clip(beat_frames[:, None] + np.arange(3)[None, :], 0, n_frames - 1)
    accent = _zscore(energy[idx].max(axis=1)) + _zscore(low[idx].max(axis=1))
    if flux is not None and flux.size == n_frames:
        accent = accent + 0.5 * _zscore(flux[idx].max(axis=1))
    if chroma is not None and chroma.shape[-1] >= n_frames - 2:
        accent = accent + _harmonic_change_cue(
            np.asarray(chroma, dtype=np.float64)[:, :n_frames], beat_frames, n_frames
        )
    source = "accent"
    if net_prob is not None and net_prob.size >= n_frames - 2:
        np_idx = np.clip(idx, 0, net_prob.size - 1)
        accent = accent + 2.0 * _zscore(net_prob[np_idx].max(axis=1))
        source = "rnn"
    accent = np.clip(accent, -6.0, 6.0)  # bound single-beat outliers

    n = accent.size
    best = None
    for meter in (3, 4):
        if n < 2 * meter:
            continue
        score, positions = _viterbi_positions(accent, meter)
        # Prefer 4/4 on near-ties.
        score = score * (1.05 if meter == 4 and score > 0 else 1.0)
        if best is None or score > best[0]:
            best = (score, positions)

    if best is None:
        return None
    _, positions = best
    downbeat_times = beat_times[positions == 1]
    return DownbeatTrackingResult(
        downbeat_times=[float(t) for t in downbeat_times],
        beat_positions=[int(p) for p in positions],
        source=source,
    )
