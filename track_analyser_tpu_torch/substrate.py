"""The fused analysis substrate: the whole device-side analysis of a
batch of tracks.

Every spectrogram family, HPSS, novelty, chroma, key scores, loudness,
true peak, LTAS/centroid/rolloff and stereo widths are computed in one
function on the tensors of one device, for B lanes at once (the
reference's ``vmap`` over lanes, written out as a leading batch axis);
the host finishers afterwards only run the small greedy/label logic on
kB-sized curves. Counterpart of the JAX reference's ``substrate.py``,
output for output, except ``autocorr`` (the host recomputes it in
float64 from ``onset_env``).

Padding contract: tracks are padded with zeros to a bucket length;
``n_valid`` masks every global reduction (loudness gating, key chroma
means, LTAS/centroid means, stereo statistics) so padded results match
exact-shape results. Framewise curves are trimmed to the true frame
count on host.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from .config import DEFAULT_CONFIG
from .device import device_constant
from .ops import fused_stft
from .ops.chroma import chroma_from_power, chroma_stft_filterbank, cq_chroma_tribank
from .ops.filters import gaussian_filter1d, gaussian_kernel, hpss
from .ops.loudness import integrated_lufs, rms_db_curve
from .ops.mel import (
    mel_filterbank,
    melspectrogram_from_power,
    mfcc_from_log_mel,
    power_to_db,
)
from .ops.onset import onset_strength_from_mel
from .ops.resample import oversampled_peak
from .ops.spectral import balance_band_weights, spectral_centroid, spectral_rolloff
from .ops.stft import fft_frequencies, magnitude, n_frames

__all__ = ["full_track_graph", "structure_curves", "bucket_length", "pad_to_bucket", "pack_outputs", "unpack_outputs"]


def bucket_length(n: int, *, hop: int = 512, min_bucket: int = 1 << 15) -> int:
    """Pad target: geometric buckets (8 steps per octave) rounded up to a
    multiple of hop*128 samples."""

    n = max(n, min_bucket)
    exp = int(np.ceil(8.0 * np.log2(n)))
    candidate = int(np.ceil(2.0 ** (exp / 8.0)))
    quantum = hop * 128
    return int(np.ceil(candidate / quantum)) * quantum


def pad_to_bucket(y: np.ndarray, *, hop: int = 512) -> "tuple[np.ndarray, int]":
    """Zero-pad the last axis to its bucket length (host helper).

    Returns ``(padded, f_valid)`` with ``f_valid = 1 + n // hop``: the one
    place that formula lives for the report's tempogram and the two
    separators."""

    y = np.asarray(y, dtype=np.float32)
    n = y.shape[-1]
    padded = np.zeros(y.shape[:-1] + (bucket_length(n, hop=hop),), dtype=np.float32)
    padded[..., :n] = y
    return padded, 1 + n // hop


def _masked_mean(x: torch.Tensor, mask: torch.Tensor, dim) -> torch.Tensor:
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    num = torch.where(mask, x, zero).sum(dim=dim)
    den = torch.clamp_min(mask.expand_as(x).sum(dim=dim), 1)
    return num / den


def _smooth_valid(curve: torch.Tensor, f_valid: torch.Tensor, sigma: float) -> torch.Tensor:
    """Gaussian-smooth framewise curves (B, ..., T) as if lane b ended at
    ``f_valid[b]``.

    Every position at or beyond a lane's ``f_valid`` reads its mirror
    across the last valid frame, and the array is extended by the kernel
    radius, so the result over [0, f_valid) equals the exact-shape
    reflect-boundary smoothing for any padding length. Values at padded
    positions are meaningless; callers mask them."""

    radius = int(gaussian_kernel(float(sigma)).shape[0] // 2)
    total = curve.shape[-1]
    ext_idx = torch.arange(total + radius, device=curve.device)
    fv = f_valid[:, None]
    idx = torch.where(
        ext_idx < fv,
        torch.clamp_max(ext_idx, total - 1),
        torch.clamp(2 * fv - 2 - ext_idx, 0, total - 1),
    )  # (B, T + radius): the per-lane mirror
    idx = idx.view((idx.shape[0],) + (1,) * (curve.dim() - 2) + (idx.shape[1],))
    ext = torch.gather(curve, -1, idx.expand(curve.shape[:-1] + (idx.shape[-1],)))
    return gaussian_filter1d(ext, sigma=sigma)[..., :total]


def _minmax_normalise(curve: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Min-max normalise each lane of (B, T) over its masked frames."""

    big = torch.full((), 3.4e38, dtype=curve.dtype, device=curve.device)
    lo = torch.where(mask, curve, big).amin(dim=-1, keepdim=True)
    hi = torch.where(mask, curve, -big).amax(dim=-1, keepdim=True)
    span = hi - lo
    flat = span < 1e-9
    out = torch.where(
        flat, torch.zeros_like(curve), (curve - lo) / torch.where(flat, torch.ones_like(span), span)
    )
    return torch.where(mask, out, torch.zeros_like(out))


def _rms_params(sr: int, seconds: float) -> tuple[int, int]:
    fl = max(1024, int(round(sr * seconds)))
    if fl % 2:
        fl += 1
    return fl, max(1, fl // 2)


def structure_curves(
    mag: torch.Tensor,
    mel_power: torch.Tensor,
    env: torch.Tensor,
    f_valid: torch.Tensor,
    *,
    sr: int,
    hop: int,
) -> tuple:
    """The structure curves of a batch: (novelty, normalised energy
    novelty, percussive column sums, harmonic column sums), each (B, T)
    and zero beyond each lane's ``f_valid``.

    ``mag`` (B, bins, T) is the 2048-point |STFT|, ``mel_power`` its mel
    power and ``env`` the onset envelope, already masked. HPSS runs
    through ``median31``. The novelty is 0.5 spectral flux + 0.3 MFCC
    self-similarity (cumulative-sum moving means over +-2 s) + 0.2
    percussive-ratio energy novelty, each min-max normalised over the
    valid frames, then smoothed. The fused graph and the per-module
    structure graph both call this one function, so their curves cannot
    drift apart."""

    cfg = DEFAULT_CONFIG
    dev = mag.device
    total_frames = mag.shape[-1]
    frame_idx = torch.arange(total_frames, device=dev)
    fmask = frame_idx < f_valid[:, None]
    zero = torch.zeros((), dtype=torch.float32, device=dev)

    harmonic, percussive = hpss(mag, kernel_size=cfg.hpss_kernel, power=cfg.hpss_power)

    log_mel = power_to_db(mel_power + 1e-9, dims=(-2, -1))
    mfcc = mfcc_from_log_mel(log_mel, cfg.n_mfcc)  # (B, n_mfcc, T)
    mfcc = _smooth_valid(mfcc, f_valid, 1.0)
    context = max(2, int(round(cfg.novelty_context_seconds * sr / float(hop))))
    cs = torch.cat([torch.zeros_like(mfcc[..., :1]), torch.cumsum(mfcc, dim=-1)], dim=-1)
    lo = torch.clamp(frame_idx - context, 0, total_frames)
    hi = torch.clamp(frame_idx + context, 0, total_frames)
    left_mean = (cs[..., frame_idx] - cs[..., lo]) / torch.clamp_min(frame_idx - lo, 1)
    right_mean = (cs[..., hi] - cs[..., frame_idx]) / torch.clamp_min(hi - frame_idx, 1)
    ln = left_mean / (torch.linalg.vector_norm(left_mean, dim=-2, keepdim=True) + 1e-9)
    rn = right_mean / (torch.linalg.vector_norm(right_mean, dim=-2, keepdim=True) + 1e-9)
    sim = 1.0 - (ln * rn).sum(dim=-2)
    sim_valid = (frame_idx >= context) & (frame_idx < (f_valid - context)[:, None])
    self_similarity = torch.where(sim_valid, sim, zero)

    perc_col = torch.where(fmask, percussive.sum(dim=-2), zero)
    harm_col = torch.where(fmask, harmonic.sum(dim=-2), zero)
    ratio_curve = perc_col / (perc_col + harm_col + 1e-9)
    ratio_sigma = max(1.0, 0.5 * sr / float(hop))
    ratio_smooth = _smooth_valid(ratio_curve, f_valid, ratio_sigma)
    energy_novelty = torch.abs(torch.diff(ratio_smooth, prepend=ratio_smooth[..., 0:1]))

    w_flux, w_sim, w_energy = cfg.novelty_weights
    combined = (
        w_flux * _minmax_normalise(env, fmask)
        + w_sim * _minmax_normalise(self_similarity, fmask)
        + w_energy * _minmax_normalise(energy_novelty, fmask)
    )
    novelty = torch.where(fmask, _smooth_valid(combined, f_valid, cfg.novelty_smooth_sigma), zero)
    return novelty, _minmax_normalise(energy_novelty, fmask), perc_col, harm_col


def _key_profiles() -> np.ndarray:
    """(24, 12): the unit major profile rotated to each of the 12 tonics,
    then the unit minor profile likewise."""

    from .harmony import MAJOR_PROFILE, MINOR_PROFILE  # host constants

    major = MAJOR_PROFILE / np.linalg.norm(MAJOR_PROFILE)
    minor = MINOR_PROFILE / np.linalg.norm(MINOR_PROFILE)
    return np.stack([np.roll(major, s) for s in range(12)] + [np.roll(minor, s) for s in range(12)])


def _ms_magnitude(ms: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """|STFT| (B, 2, bins, frames) of the [mid, side] stack (B, 2, n).

    With ``TA_PALLAS_STFT=1`` in the environment (``fused_stft.switched_on``)
    the (2B, n) stack goes through the fused kernel ``ops/fused_stft`` (on
    a CPU tensor, its plain version), as the reference routes it through
    its Pallas kernel; otherwise through ``ops/stft.magnitude`` (cuFFT on
    the card), the reference's default."""

    if fused_stft.switched_on():
        b, c, n = ms.shape
        out = fused_stft.stft_magnitude(ms.reshape(b * c, n), n_fft, hop)
        return out.view((b, c) + out.shape[1:])
    return magnitude(ms, n_fft, hop, power=1.0)


def full_track_graph(
    stereo: torch.Tensor, n_valid: torch.Tensor, *, sr: int
) -> Dict[str, torch.Tensor]:
    """Complete device-side analysis of a batch of (padded) tracks.

    Args:
      stereo: float32 (B, 2, n_padded) channel-major samples, zeros beyond
        each lane's ``n_valid`` (mono sources duplicate their channel; the
        downmix happens here).
      n_valid: int64 (B,) true sample counts, on ``stereo``'s device (the
        reference's traced ``n_valid`` under ``vmap``).
      sr: sample rate.

    Returns a dict of tensors on ``stereo``'s device, each with a leading
    batch axis; see ``parallel/batch.result_from_graph_outputs`` for how
    each is used. Lane b equals the reference's graph of lane b alone.
    """

    dev = stereo.device
    if stereo.dim() != 3 or stereo.shape[1] != 2:
        raise ValueError(f"full_track_graph takes (B, 2, n) stereo, got {tuple(stereo.shape)}")
    n_valid = torch.as_tensor(n_valid, dtype=torch.int64, device=dev)
    left, right = stereo[:, 0], stereo[:, 1]
    y = 0.5 * (left + right)  # (B, n); mid == mono downmix
    side = 0.5 * (left - right)
    cfg = DEFAULT_CONFIG
    hop = cfg.hop_length
    n_fft = cfg.n_fft
    total_frames = n_frames(y.shape[-1], hop)
    frame_idx = torch.arange(total_frames, device=dev)
    f_valid = 1 + n_valid // hop  # (B,)
    fmask = frame_idx < f_valid[:, None]  # (B, T)
    fmask_bins = fmask[:, None, :]  # (B, 1, T)
    zero = torch.zeros((), dtype=torch.float32, device=dev)

    out: Dict[str, torch.Tensor] = {"f_valid": f_valid}

    # ---- shared 2048 STFT family: one batched STFT of [mid, side] -------
    ms_mag = _ms_magnitude(torch.stack([y, side], dim=1), n_fft, hop)
    mag = ms_mag[:, 0]  # (B, bins, T)
    power = mag * mag
    mel_power = melspectrogram_from_power(power, device_constant(mel_filterbank, sr, n_fft, cfg.n_mels, device=dev))

    env = onset_strength_from_mel(mel_power, n_fft=n_fft, hop_length=hop)
    env = torch.where(fmask, env, zero)
    out["onset_env"] = env

    # Linear accent curves for the downbeat decoder.
    n_low = max(2, int(150.0 * n_fft / sr))
    out["beat_energy"] = torch.where(fmask, torch.sqrt(mel_power.sum(dim=-2) + 1e-12), zero)
    out["low_energy"] = torch.where(
        fmask, torch.sqrt(power[:, :n_low].sum(dim=-2) + 1e-12), zero
    )

    # ---- structure: HPSS + combined novelty -----------------------------
    novelty, energy_novelty, perc_col, harm_col = structure_curves(
        mag, mel_power, env, f_valid, sr=sr, hop=hop
    )
    out["novelty"] = novelty
    out["energy_novelty"] = energy_novelty
    out["perc_col"] = perc_col
    out["harm_col"] = harm_col

    # ---- features: LTAS / centroid / rolloff ----------------------------
    freqs_t = device_constant(fft_frequencies, sr, n_fft, device=dev, dtype=torch.float32)
    out["ltas"] = _masked_mean(mag, fmask_bins, dim=-1)  # (B, bins)
    out["centroid"] = torch.where(fmask, spectral_centroid(mag, freqs_t), zero)
    out["rolloff"] = torch.where(fmask, spectral_rolloff(mag, freqs_t, cfg.rolloff_percent), zero)

    # ---- harmony: chroma projections + key scores -----------------------
    chroma_st = chroma_from_power(power, device_constant(chroma_stft_filterbank, sr, n_fft, device=dev))
    chroma_cq = cq_chroma_tribank(
        y,
        mag,
        sr=sr,
        hop=cfg.cq_hop,
        family_n_fft=n_fft,
        family_hop=hop,
        low_n_fft=cfg.cq_low_n_fft,
        mid_n_fft=cfg.cq_mid_n_fft,
        decim=cfg.cq_decim,
        low_octaves=cfg.cq_low_octaves,
        family_octave=cfg.cq_family_octave,
        keep_hz=cfg.cq_keep_hz,
    )
    # The coarse grid ships; the hop-resolution repeat feeds the key means.
    out["chroma_cq_coarse"] = chroma_cq
    chroma_cq = torch.repeat_interleave(chroma_cq, cfg.cq_hop // hop, dim=-1)[..., :total_frames]
    out["chroma_cq"] = chroma_cq

    rot_t = device_constant(_key_profiles, device=dev, dtype=torch.float32)  # (24, 12)
    scores = torch.zeros((y.shape[0], 24), device=dev)
    for chroma in (chroma_cq, chroma_st):
        cmean = _masked_mean(chroma, fmask_bins, dim=-1)  # (B, 12)
        norm = torch.linalg.vector_norm(cmean, dim=-1, keepdim=True)
        cnorm = cmean / torch.where(norm > 0, norm, torch.ones_like(norm))
        scores = scores + torch.where(norm > 0, (rot_t @ cnorm[..., None])[..., 0], zero)
    out["key_scores"] = scores

    # ---- spectral balance on the shared 2048 family ---------------------
    bal_w = device_constant(balance_band_weights, sr, n_fft, device=dev)
    bal_col = torch.where(fmask_bins, mag, zero).sum(dim=-1)  # (B, bins)
    bal_sums = (bal_w @ bal_col[..., None])[..., 0]  # (B, 3)
    out["balance_total"] = bal_sums.sum(dim=-1)
    out["balance_low"] = bal_sums[:, 0]
    out["balance_mid"] = bal_sums[:, 1]
    out["balance_high"] = bal_sums[:, 2]

    # ---- loudness ---------------------------------------------------------
    smask = torch.arange(y.shape[-1], device=dev) < n_valid[:, None]  # (B, n)
    block = cfg.loudness_block_seconds
    out["integrated_lufs"] = integrated_lufs(
        y,
        sr,
        block_seconds=block,
        absolute_gate=cfg.gate_absolute_lufs,
        relative_gate_lu=cfg.gate_relative_lu,
        n_valid=n_valid,
    )
    st_len, st_hop = _rms_params(sr, cfg.short_term_seconds)
    mo_len, mo_hop = _rms_params(sr, block)
    out["short_term_db"] = rms_db_curve(y, st_len, st_hop)
    out["momentary_db"] = rms_db_curve(y, mo_len, mo_hop)
    out["true_peak"] = oversampled_peak(y, cfg.true_peak_oversample)
    out["rms"] = torch.sqrt(_masked_mean(y * y, smask, dim=-1))

    # ---- stereo image -------------------------------------------------------
    n_ok = torch.clamp_min(smask.sum(dim=-1, keepdim=True), 1)
    lmean = torch.where(smask, left, zero).sum(dim=-1, keepdim=True) / n_ok
    rmean = torch.where(smask, right, zero).sum(dim=-1, keepdim=True) / n_ok
    lc = torch.where(smask, left - lmean, zero)
    rc = torch.where(smask, right - rmean, zero)
    denom = torch.linalg.vector_norm(lc, dim=-1) * torch.linalg.vector_norm(rc, dim=-1)
    ok = denom > 1e-12
    dot = torch.linalg.vecdot(lc, rc)
    corr = torch.clamp(dot / torch.where(ok, denom, torch.ones_like(denom)), -1.0, 1.0)
    out["stereo_corr_centered"] = torch.where(ok, corr, torch.ones_like(corr))
    out["stereo_balance"] = _masked_mean(torch.abs(left), smask, dim=-1) - _masked_mean(
        torch.abs(right), smask, dim=-1
    )
    # y IS the mid channel, so mid_rms == rms.
    out["mid_rms"] = out["rms"]
    out["side_rms"] = torch.sqrt(_masked_mean(side * side, smask, dim=-1))

    mid_e = torch.where(fmask_bins, power, zero)
    side_e = torch.where(fmask_bins, ms_mag[:, 1] * ms_mag[:, 1], zero)
    nyq = sr / 2.0
    frames_ok = torch.clamp_min(f_valid, 1)
    widths = []
    for lo_f, hi_f in ((0.0, min(200.0, nyq)), (200.0, min(2000.0, nyq)), (2000.0, nyq)):
        bmask = ((freqs_t >= lo_f) & (freqs_t <= hi_f))[:, None]
        nb = torch.clamp_min(bmask.sum(), 1) * frames_ok
        m = torch.where(bmask, mid_e, zero).sum(dim=(-2, -1)) / nb
        s = torch.where(bmask, side_e, zero).sum(dim=(-2, -1)) / nb
        quiet = m <= 1e-12
        ratio = s / torch.where(quiet, torch.ones_like(m), m)
        widths.append(torch.where(quiet, zero, torch.sqrt(ratio)))
    out["stereo_widths"] = torch.stack(widths, dim=-1)  # (B, 3)

    return out


# ---------------------------------------------------------------------------
# Packed outputs: ~20 tensors travel device -> host as 4 buffers, with the
# decision-robust rows at half precision. The finishers see that rounding,
# so the port keeps the reference's packing exactly.
# ---------------------------------------------------------------------------

# Framewise rows that stay float32 end to end (BPM regression, dB curves
# near -120 dB, the two accent curves that drive decision decoders).
_CURVE_ROWS = (
    "onset_env",
    "short_term_db",
    "momentary_db",
    "beat_energy",
    "low_energy",
)

# Rows at 16 bits: f16 where values are bounded (normalised novelties, Hz
# curves below Nyquist), bf16 (float32 range) for unbounded energy rows.
_CURVE_ROWS_HALF = (
    ("novelty", "f16"),
    ("energy_novelty", "f16"),
    ("centroid", "f16"),
    ("rolloff", "f16"),
    ("perc_col", "bf16"),
    ("harm_col", "bf16"),
)
_SCALARS = (
    "f_valid",
    "integrated_lufs",
    "true_peak",
    "rms",
    "balance_total",
    "balance_low",
    "balance_mid",
    "balance_high",
    "stereo_corr_centered",
    "stereo_balance",
    "mid_rms",
    "side_rms",
)


def pack_outputs(out: Dict[str, torch.Tensor]) -> tuple:
    """(curves (B, 5, W) float32, curves_half (B, 6, W) int16 bit
    patterns, chroma_coarse (B, 12, F/4) float16, vec (B, V) float32)
    from a batch of graph outputs: the 16-bit rows are rounded to f16 or
    bf16 and share one buffer by bit pattern; the chroma ships on its
    coarse cq_hop grid; the LTAS rides in ``vec``."""

    width = max(
        max(int(out[name].shape[-1]) for name in _CURVE_ROWS),
        max(int(out[name].shape[-1]) for name, _ in _CURVE_ROWS_HALF),
    )

    def _padded(name: str) -> torch.Tensor:
        x = out[name].to(torch.float32)
        return F.pad(x, (0, width - x.shape[-1]))

    curves = torch.stack([_padded(name) for name in _CURVE_ROWS], dim=1)
    half_rows = []
    for name, kind in _CURVE_ROWS_HALF:
        h = _padded(name).to(torch.float16 if kind == "f16" else torch.bfloat16)
        half_rows.append(h.view(torch.int16))
    curves_half = torch.stack(half_rows, dim=1)
    vec = torch.cat(
        [
            torch.stack([out[name].to(torch.float32) for name in _SCALARS], dim=-1),
            out["stereo_widths"].to(torch.float32),
            out["key_scores"].to(torch.float32),
            out["ltas"].to(torch.float32),
        ],
        dim=-1,
    )
    return curves, curves_half, out["chroma_cq_coarse"].to(torch.float16), vec


def _bf16_bits_to_f32(bits: np.ndarray) -> np.ndarray:
    """bfloat16 bit patterns (uint16) -> float32, exactly."""

    return (bits.astype(np.uint32) << 16).view(np.float32)


def unpack_outputs(
    curves: np.ndarray,
    curves_half: np.ndarray,
    chroma_coarse: np.ndarray,
    vec: np.ndarray,
) -> Dict[str, np.ndarray]:
    """Host-side inverse of ``pack_outputs`` for ONE lane (numpy in,
    numpy out): the host unpacks a batch lane by lane."""

    out: Dict[str, np.ndarray] = {
        name: np.asarray(curves[i]) for i, name in enumerate(_CURVE_ROWS)
    }
    half = np.ascontiguousarray(curves_half).view(np.uint16)
    for i, (name, kind) in enumerate(_CURVE_ROWS_HALF):
        if kind == "f16":
            out[name] = half[i].view(np.float16).astype(np.float32)
        else:
            out[name] = _bf16_bits_to_f32(half[i])
    rep = DEFAULT_CONFIG.cq_hop // DEFAULT_CONFIG.hop_length
    total_frames = curves.shape[-1]
    out["chroma_cq"] = np.repeat(
        np.asarray(chroma_coarse).astype(np.float32), rep, axis=1
    )[:, :total_frames]
    for i, name in enumerate(_SCALARS):
        out[name] = np.asarray(vec[i])
    out["stereo_widths"] = np.asarray(vec[len(_SCALARS) : len(_SCALARS) + 3])
    out["key_scores"] = np.asarray(vec[len(_SCALARS) + 3 : len(_SCALARS) + 27])
    out["ltas"] = np.asarray(vec[len(_SCALARS) + 27 :])
    return out
