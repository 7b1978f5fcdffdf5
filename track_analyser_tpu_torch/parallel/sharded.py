"""Sequence parallelism: one long track's frame axis split over ranks.

Counterpart of the JAX package's ``parallel/sharded.py``. There
``shard_map`` runs one program per device of a ``seq`` mesh axis; here one
process runs per rank of a ``torch.distributed`` group (``parallel/mesh``)
and every function below is called by every rank of the group (SPMD):

* per-frame ops (window, FFT, filterbank matmuls, flux) are local;
* the sample framing needs a halo of samples from the neighbours,
  exchanged with ``mesh.neighbour_halos`` (the JAX code's ``ppermute``);
* global reductions (the dB floors, gated loudness means, key chroma
  means, stereo statistics) use ``mesh.psum`` / ``mesh.pmax``;
* the curves whose context spans the track (autocorrelation, the TCN's
  receptive field, the novelty chain) are all-gathered and computed on
  every rank.

Each rank takes the whole ``AudioInput`` and uploads only its own sample
range. HPSS runs on each rank's halo-extended spectrogram through
``ops/filters.hpss``, so ``median31`` launches once per axis per rank.
The framewise outputs are all-gathered, so every rank returns the same
full-length outputs and the same ``TrackAnalysisResult``. The device
``autocorr`` output of the JAX code is not computed: the host recomputes
the autocorrelation in float64 from ``onset_env``, as for the fused graph.

``run_sharded`` starts the ranks from one process.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..config import DEFAULT_CONFIG, DEFAULT_SEED
from ..ops.mel import mel_filterbank
from ..ops.stft import frame_signal, hann_window
from . import mesh
from .mesh import SeqGroup

__all__ = [
    "shard_halo_exchange",
    "sharded_onset_envelope",
    "frames_per_shard",
    "hpss_shape",
    "sharded_track_outputs",
    "analyse_track_sharded",
    "run_sharded",
]


def shard_halo_exchange(x: torch.Tensor, halo: int, g: SeqGroup) -> torch.Tensor:
    """Append the first ``halo`` elements of the right neighbour's shard.

    The last shard receives zeros (the zero padding at the track's end)."""

    _, from_right = mesh.neighbour_halos(x[..., :halo], x[..., :0], g)
    return torch.cat([x, from_right], dim=-1)


def _local_envelope(
    y_local: torch.Tensor, *, sr: int, n_fft: int, hop: int, frames_per_shard: int, g: SeqGroup
) -> torch.Tensor:
    """This shard's onset-envelope frames.

    Shard s owns frames [s*F, (s+1)*F). Frame t needs samples
    [t*hop - n_fft/2, t*hop + n_fft/2) of the centre-padded signal: a left
    overlap of n_fft/2 and a right halo of n_fft/2 plus one frame (hop)
    for the flux difference."""

    pad = n_fft // 2
    # One exchange: the right halo completes the last owned frame and the
    # lag-1 flux reference frame; the left one is the previous shard's
    # tail (zeros on shard 0: the centre pad).
    from_left, from_right = mesh.neighbour_halos(y_local[..., : pad + hop], y_local[..., -pad:], g)
    y_full = torch.cat([from_left, y_local, from_right], dim=-1)

    win = torch.as_tensor(hann_window(n_fft), device=y_local.device)
    frames = frame_signal(y_full, n_fft, hop, center=False)[: frames_per_shard + 1] * win
    power = torch.abs(torch.fft.rfft(frames, n=n_fft, dim=-1)) ** 2
    fb = torch.as_tensor(mel_filterbank(sr, n_fft, DEFAULT_CONFIG.n_mels), device=y_local.device)
    mel_power = power @ fb.T  # (F+1, mels)

    # The dB floor (top_db) is relative to the GLOBAL max.
    log_spec = 10.0 * torch.log10(torch.clamp_min(mel_power, 1e-10))
    global_max = mesh.pmax(log_spec.max(), g)
    log_spec = torch.maximum(log_spec, global_max - 80.0)
    flux = torch.clamp_min(log_spec[1:] - log_spec[:-1], 0.0)
    return flux.mean(dim=-1)


def sharded_onset_envelope(
    y: np.ndarray, sr: int, group: SeqGroup, *, hop: int = 512, n_fft: int = 2048
) -> np.ndarray:
    """Onset envelope of one long track (every rank passes the whole
    ``y``), frame-sharded over ``group``; every rank returns the whole
    envelope, aligned as ``tempo.onset_envelope``'s (the same left shift).

    The signal is padded so that each shard owns an equal frame count;
    the samples the last frame and its flux need come from the halo
    exchange (zeros after the last shard)."""

    g = group
    n = y.shape[-1]
    total_frames = 1 + n // hop
    frames_per_shard = -(-total_frames // g.size)
    own = frames_per_shard * hop
    yp = np.zeros(own * g.size, dtype=np.float32)
    yp[:n] = y
    y_local = torch.from_numpy(yp[g.rank * own : (g.rank + 1) * own]).to(g.device)
    with torch.inference_mode():
        env_local = _local_envelope(
            y_local, sr=sr, n_fft=n_fft, hop=hop, frames_per_shard=frames_per_shard, g=g
        )
        # Shard s computes the flux of frames [s*F+1, (s+1)*F+1); the
        # envelope convention shifts right by lag + n_fft // (2*hop).
        env_flux = mesh.all_gather(env_local, g).reshape(-1).cpu().numpy()
    shift = 1 + n_fft // (2 * hop)
    env = np.zeros(total_frames, dtype=np.float64)
    src = env_flux[: max(0, total_frames - shift)]
    env[shift : shift + src.size] = src
    return env


# ---------------------------------------------------------------------------
# Full sequence-sharded track analysis
# ---------------------------------------------------------------------------
#
# Each rank computes the substrate on an extended local block (own samples
# plus a +-halo of frames exchanged with its neighbours); global properties
# reduce with psum / pmax. Numerics match substrate.full_track_graph (see
# tests/test_torch_sharding.py).

def _halo_frames(sr: int, hop: int = 512) -> int:
    """Frames of halo covering every temporal context in the substrate:
    centre padding (2), flux lag (1), HPSS median (15), MFCC context
    (2 s), ratio gaussian radius (4 sigma of 0.5 s), novelty smoothing
    (7), K-weighting FIR (16384 samples), true-peak taps. Rounded up to a
    multiple of 4 so the coarse chroma grid stays aligned."""

    ratio_radius = int(4.0 * max(1.0, 0.5 * sr / hop) + 0.5)
    context = max(2, int(round(2.0 * sr / hop)))
    kweight = -(-16_384 // hop)
    h = max(ratio_radius, context, kweight) + 48
    return -(-h // 4) * 4


def frames_per_shard(n_valid: int, size: int, hop: int = 512) -> int:
    """Frames each of ``size`` ranks owns for an ``n_valid``-sample track:
    the frames split evenly, rounded up to a multiple of cq_hop/hop (=4)
    so that the coarse chroma grid aligns with the shard boundaries."""

    fs = -(-(1 + int(n_valid) // hop) // size)
    return -(-fs // 4) * 4


def hpss_shape(n_valid: int, sr: int, size: int) -> "tuple[int, int]":
    """(bins, frames) of the magnitude each rank hands ``hpss`` (and so
    ``median31``): its own frames plus a halo on each side."""

    cfg = DEFAULT_CONFIG
    fs = frames_per_shard(n_valid, size, cfg.hop_length)
    return (1 + cfg.n_fft // 2, fs + 2 * _halo_frames(sr, cfg.hop_length) + 1)


def _exchange_sample_halos(x: torch.Tensor, halo: int, g: SeqGroup) -> torch.Tensor:
    """[left halo | own | right halo] along the last axis; the edges read
    zeros."""

    from_left, from_right = mesh.neighbour_halos(x[..., :halo], x[..., -halo:], g)
    return torch.cat([from_left, x, from_right], dim=-1)


def _masked_pmean(x: torch.Tensor, mask: torch.Tensor, g: SeqGroup) -> torch.Tensor:
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    sums = mesh.psum(torch.stack([torch.where(mask, x, zero).sum(), mask.sum().to(x.dtype)]), g)
    return sums[0] / torch.clamp_min(sums[1], 1.0)


def _gather_curves(own: torch.Tensor, g: SeqGroup) -> torch.Tensor:
    """(..., S*fs): the ranks' own (..., fs) frames side by side."""

    gathered = mesh.all_gather(own, g)  # (S, ..., fs)
    return torch.movedim(gathered, 0, -2).reshape(own.shape[:-1] + (-1,))


def _local_track_analysis(
    stereo_local: torch.Tensor, n_valid: int, *, sr: int, frames_per_shard: int, g: SeqGroup, net=None
) -> Dict[str, torch.Tensor]:
    """Shard-local substrate over the halo-extended block (see the module
    doc). Follows ``substrate.full_track_graph`` stage by stage; every
    deviation is a halo slice or a collective in place of a local
    reduction. With ``net`` (the bundled TCN) every rank runs it over the
    all-gathered mel features, so that the sharded path reports the same
    net evidence as the fused path. Framewise outputs come back whole
    (all-gathered), scalars replicated."""

    from ..harmony import MAJOR_PROFILE, MINOR_PROFILE
    from ..ops.chroma import chroma_from_power, chroma_stft_filterbank, cq_chroma_tribank
    from ..ops.filters import hpss
    from ..ops.loudness import k_weighted
    from ..ops.mel import melspectrogram_from_power, mfcc_from_log_mel, power_to_db
    from ..ops.resample import oversampled_peak
    from ..ops.spectral import balance_band_weights, spectral_centroid, spectral_rolloff
    from ..ops.stft import fft_frequencies, magnitude, stft as stft_op
    from ..substrate import _minmax_normalise, _smooth_valid

    cfg = DEFAULT_CONFIG
    hop = cfg.hop_length
    n_fft = cfg.n_fft
    hf = _halo_frames(sr, hop)
    fs_own = frames_per_shard
    shard, n_sh = g.rank, g.size
    dev = stereo_local.device
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    neg_inf = torch.tensor(-float("inf"), dtype=torch.float32, device=dev)

    halo_samples = hf * hop
    stereo_ext = _exchange_sample_halos(stereo_local, halo_samples, g)
    y_ext = stereo_ext.mean(dim=0)

    # Global frame bookkeeping: own frame j <-> global frame shard*fs + j
    # <-> extended-block frame hf + j.
    f_valid = 1 + n_valid // hop
    own_global = shard * fs_own + torch.arange(fs_own, device=dev)
    own_mask = own_global < f_valid  # (fs_own,)
    f_ext = 1 + y_ext.shape[-1] // hop
    ext_idx = torch.arange(f_ext, device=dev)
    ext_global = shard * fs_own - hf + ext_idx
    ext_valid = (ext_global >= 0) & (ext_global < f_valid)
    own_sel = slice(hf, hf + fs_own)
    own_valid_ext = (ext_idx >= hf) & (ext_idx < hf + fs_own) & ext_valid

    out: Dict[str, torch.Tensor] = {}

    # ---- 2048 STFT family (extended block) ----------------------------
    mag = magnitude(y_ext, n_fft, hop, power=1.0)[:, :f_ext]
    power = mag * mag
    mel_power = melspectrogram_from_power(power, mel_filterbank(sr, n_fft, cfg.n_mels))

    # Onset envelope: the dB floor (top_db) is relative to the GLOBAL max.
    log_spec = 10.0 * torch.log10(torch.clamp_min(mel_power, 1e-10))
    gmax = mesh.pmax(torch.where(ext_valid[None, :], log_spec, neg_inf).max(), g)
    s_db = torch.maximum(log_spec, gmax - 80.0)
    flux = torch.clamp_min(s_db[:, 1:] - s_db[:, :-1], 0.0)
    lead = 1 + n_fft // (2 * hop)
    env_ext = torch.nn.functional.pad(flux.mean(dim=0), (lead, 0))[:f_ext]
    # The fused graph's left pad zeroes the first lag + n_fft//(2*hop)
    # frames; shard 0 would otherwise compute flux for pre-start windows.
    env_ext = torch.where(ext_valid & (ext_global >= lead), env_ext, zero)
    env_own = torch.where(own_mask, env_ext[own_sel], zero)
    env_full = _gather_curves(env_own, g)
    out["onset_env"] = env_full

    # Accent curves for the downbeat decoder.
    n_low = max(2, int(150.0 * n_fft / sr))
    beat_energy = torch.where(own_mask, torch.sqrt(mel_power.sum(dim=0) + 1e-12)[own_sel], zero)
    low_energy = torch.where(own_mask, torch.sqrt(power[:n_low].sum(dim=0) + 1e-12)[own_sel], zero)

    # ---- TCN downbeat activations ---------------------------------------
    # The net's dilated receptive field (~3 s) spans shard boundaries, so
    # the mel features are gathered and every rank runs the net over them
    # (the fused graph's downbeat_net.activation_graph, on the whole track).
    if net is not None:
        mel_own = torch.where(own_mask[None, :], mel_power[:, own_sel], zero)
        mel_full = _gather_curves(mel_own, g)  # (mels, S*fs)
        feats = power_to_db(mel_full).T  # (T_pad, mels)
        fmask = torch.arange(feats.shape[0], device=dev) < f_valid
        count = max(min(f_valid, feats.shape[0]), 1) * feats.shape[1]
        mu = torch.where(fmask[:, None], feats, zero).sum() / count
        var = torch.where(fmask[:, None], (feats - mu) ** 2, zero).sum() / count
        feats = (feats - mu) / (torch.sqrt(var) + 1e-6)
        prob = torch.softmax(net(feats), dim=-1)[:, 2]
        out["net_prob"] = torch.where(fmask, prob, zero)

    # ---- structure curves ----------------------------------------------
    # The fused graph's median/smoothing stages REFLECT the spectrogram at
    # the track's start and end; the end shards' zero halos are right for
    # the STFT, so the reflection takes their place for the HPSS chain.
    left = torch.flip(mag[:, hf + 1 : 2 * hf + 1], dims=(1,)) if shard == 0 else mag[:, :hf]
    right = torch.flip(mag[:, -(2 * hf + 1) : -(hf + 1)], dims=(1,)) if shard == n_sh - 1 else mag[:, -hf:]
    mag_hpss = torch.cat([left, mag[:, hf:-hf], right], dim=1)
    harmonic, percussive = hpss(mag_hpss, kernel_size=cfg.hpss_kernel, power=cfg.hpss_power)

    log_mel = power_to_db(mel_power + 1e-9, top_db=None)
    gmax2 = mesh.pmax(torch.where(ext_valid[None, :], log_mel, neg_inf).max(), g)
    log_mel = torch.maximum(log_mel, gmax2 - 80.0)
    mfcc_ext = mfcc_from_log_mel(log_mel, cfg.n_mfcc)
    # Self-similarity on the whole gathered MFCC matrix (~50 B a frame):
    # the substrate's exact chain, the padded tail included.
    f_valid_t = torch.tensor([f_valid], device=dev)
    mfcc_full = _gather_curves(torch.where(own_mask[None, :], mfcc_ext[:, own_sel], zero), g)
    mfcc_full = _smooth_valid(mfcc_full[None], f_valid_t, 1.0)[0]
    t_full = mfcc_full.shape[1]
    context = max(2, int(round(cfg.novelty_context_seconds * sr / float(hop))))
    cs = torch.cat([torch.zeros_like(mfcc_full[:, :1]), torch.cumsum(mfcc_full, dim=1)], dim=1)
    fidx = torch.arange(t_full, device=dev)
    lo_i = torch.clamp(fidx - context, 0, t_full)
    hi_i = torch.clamp(fidx + context, 0, t_full)
    left_mean = (cs[:, fidx] - cs[:, lo_i]) / torch.clamp_min(fidx - lo_i, 1)
    right_mean = (cs[:, hi_i] - cs[:, fidx]) / torch.clamp_min(hi_i - fidx, 1)
    ln = left_mean / (torch.linalg.vector_norm(left_mean, dim=0) + 1e-9)
    rn = right_mean / (torch.linalg.vector_norm(right_mean, dim=0) + 1e-9)
    sim = 1.0 - (ln * rn).sum(dim=0)
    sim_full = torch.where((fidx >= context) & (fidx < f_valid - context), sim, zero)

    perc_raw = percussive.sum(dim=0)
    harm_raw = harmonic.sum(dim=0)
    perc_own = torch.where(own_mask, perc_raw[own_sel], zero)
    harm_own = torch.where(own_mask, harm_raw[own_sel], zero)

    # ---- features (framewise) ------------------------------------------
    freqs = fft_frequencies(sr, n_fft)
    centroid = torch.where(own_mask, spectral_centroid(mag, freqs)[own_sel], zero)
    rolloff = torch.where(own_mask, spectral_rolloff(mag, freqs, cfg.rolloff_percent)[own_sel], zero)

    # ---- harmony (framewise) -------------------------------------------
    chroma_st = chroma_from_power(power, chroma_stft_filterbank(sr, n_fft))
    # Three-bank CQ chroma over the halo-extended block: the decimation
    # FIR and the 1.49 s low-bank window sit inside the exchanged halo,
    # and the block starts on a cq_hop multiple (hf % 4 == 0), so the
    # decimated frame grids stay aligned with the fused graph's.
    chroma_cq_coarse = cq_chroma_tribank(
        y_ext,
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
    chroma_cq_ext = torch.repeat_interleave(chroma_cq_coarse, cfg.cq_hop // hop, dim=1)[:, :f_ext]

    # One gather for every own-frame curve.
    own_rows = torch.cat(
        [torch.stack([beat_energy, low_energy, perc_own, harm_own, centroid, rolloff]), chroma_cq_ext[:, own_sel]]
    )
    full_rows = _gather_curves(own_rows, g)
    for i, name in enumerate(("beat_energy", "low_energy", "perc_col", "harm_col", "centroid", "rolloff")):
        out[name] = full_rows[i]
    out["chroma_cq"] = full_rows[6:]
    perc_full, harm_full = out["perc_col"], out["harm_col"]
    fmask_full = torch.arange(perc_full.shape[0], device=dev) < f_valid

    # Novelty chain on the whole gathered curves: the substrate's exact
    # code on exact full-length arrays, the _smooth_valid treatment of the
    # padded tail included.
    ratio_full = perc_full / (perc_full + harm_full + 1e-9)
    ratio_sigma = max(1.0, 0.5 * sr / float(hop))
    ratio_smooth = _smooth_valid(ratio_full[None], f_valid_t, ratio_sigma)[0]
    energy_novelty_full = torch.abs(torch.diff(ratio_smooth, prepend=ratio_smooth[0:1]))
    w_flux, w_sim, w_energy = cfg.novelty_weights
    combined_full = (
        w_flux * _minmax_normalise(env_full, fmask_full)
        + w_sim * _minmax_normalise(sim_full, fmask_full)
        + w_energy * _minmax_normalise(energy_novelty_full, fmask_full)
    )
    smoothed = _smooth_valid(combined_full[None], f_valid_t, cfg.novelty_smooth_sigma)[0]
    out["novelty"] = torch.where(fmask_full, smoothed, zero)
    out["energy_novelty"] = _minmax_normalise(energy_novelty_full, fmask_full)

    # ---- global sums: LTAS, key chroma, balance -------------------------
    major = MAJOR_PROFILE / np.linalg.norm(MAJOR_PROFILE)
    minor = MINOR_PROFILE / np.linalg.norm(MINOR_PROFILE)
    rot = np.stack([np.roll(major, s) for s in range(12)] + [np.roll(minor, s) for s in range(12)])
    own_cols = own_valid_ext[None, :]
    bal_w = torch.as_tensor(balance_band_weights(sr, n_fft), device=dev)
    mag_sum = torch.where(own_cols, mag, zero).sum(dim=-1)  # (bins,)
    sums = mesh.psum(
        torch.cat(
            [
                mag_sum,
                torch.where(own_cols, chroma_cq_ext, zero).sum(dim=-1),
                torch.where(own_cols, chroma_st, zero).sum(dim=-1),
                bal_w @ mag_sum,
                own_valid_ext.sum().to(torch.float32)[None],
            ]
        ),
        g,
    )
    bins = mag.shape[0]
    lt_den = torch.clamp_min(sums[-1], 1.0)
    out["ltas"] = sums[:bins] / lt_den
    scores = torch.zeros(24, device=dev)
    rot_t = torch.as_tensor(rot, dtype=torch.float32, device=dev)
    for csum in (sums[bins : bins + 12], sums[bins + 12 : bins + 24]):
        cmean = csum / lt_den
        norm = torch.linalg.vector_norm(cmean)
        cnorm = cmean / torch.where(norm > 0, norm, torch.ones_like(norm))
        scores = scores + torch.where(norm > 0, rot_t @ cnorm, zero)
    out["key_scores"] = scores
    bal_sums = sums[bins + 24 : bins + 27]
    out["balance_total"] = bal_sums.sum()
    out["balance_low"] = bal_sums[0]
    out["balance_mid"] = bal_sums[1]
    out["balance_high"] = bal_sums[2]

    # ---- loudness -------------------------------------------------------
    yk_ext = k_weighted(y_ext, sr)
    block_len = int(round(cfg.loudness_block_seconds * sr))
    hop_g = int(round(cfg.loudness_block_seconds * 0.25 * sr))
    own_samples = fs_own * hop
    own_start = shard * own_samples
    # Blocks whose start falls in this shard's own sample range; capacity
    # covers the worst case (+1 for alignment).
    cap = own_samples // hop_g + 1
    first_block = (own_start + hop_g - 1) // hop_g
    starts_global = (first_block + torch.arange(cap, device=dev)) * hop_g
    starts_local = starts_global - own_start + halo_samples
    block_ok = (starts_global < min((shard + 1) * own_samples, n_valid - block_len + 1)) & (
        starts_local + block_len <= yk_ext.shape[-1]
    )
    cs_k = torch.cat([torch.zeros(1, device=dev), torch.cumsum(yk_ext * yk_ext, dim=0)])
    last = cs_k.shape[0] - 1
    z = (cs_k[torch.clamp(starts_local + block_len, 0, last)] - cs_k[torch.clamp(starts_local, 0, last)]) / block_len
    eps = 1e-20
    loud = -0.691 + 10.0 * torch.log10(z + eps)
    abs_ok = block_ok & (loud > cfg.gate_absolute_lufs)
    z_abs = _masked_pmean(z, abs_ok, g)
    gamma_r = -0.691 + 10.0 * torch.log10(z_abs + eps) + cfg.gate_relative_lu
    both = abs_ok & (loud > gamma_r)
    out["integrated_lufs"] = -0.691 + 10.0 * torch.log10(_masked_pmean(z, both, g) + eps)

    # True peak: the own range is claimed through the OUTPUT mask, so the
    # interpolator reads the true halo samples and no zero step is made
    # at an internal shard boundary. Own ranges partition the track, so
    # each intersample position is claimed once; padding beyond n_valid
    # is zero, as at the fused path's end of track.
    sidx = torch.arange(y_ext.shape[-1], device=dev)
    smask_ext = (sidx >= halo_samples) & (sidx < halo_samples + own_samples)
    out["true_peak"] = mesh.pmax(oversampled_peak(y_ext, cfg.true_peak_oversample, mask=smask_ext), g)
    sval = smask_ext & (sidx - halo_samples + own_start < n_valid)

    # ---- stereo: one psum of every masked sum ----------------------------
    left_ch, right_ch = stereo_ext[0], stereo_ext[1]
    mid_t = 0.5 * (left_ch + right_ch)
    side_t = 0.5 * (left_ch - right_ch)

    def msum(x):
        return torch.where(sval, x, zero).sum()

    st = mesh.psum(
        torch.stack(
            [
                sval.sum().to(torch.float32),
                msum(y_ext * y_ext),
                msum(left_ch),
                msum(right_ch),
                msum(left_ch * left_ch),
                msum(right_ch * right_ch),
                msum(left_ch * right_ch),
                msum(torch.abs(left_ch)),
                msum(torch.abs(right_ch)),
                msum(mid_t * mid_t),
                msum(side_t * side_t),
            ]
        ),
        g,
    )
    nn = torch.clamp_min(st[0], 1.0)
    s_l, s_r, s_ll, s_rr, s_lr = st[2], st[3], st[4], st[5], st[6]
    out["rms"] = torch.sqrt(st[1] / nn)
    cov = s_lr - s_l * s_r / nn
    var_l = torch.clamp_min(s_ll - s_l * s_l / nn, 0.0)
    var_r = torch.clamp_min(s_rr - s_r * s_r / nn, 0.0)
    denom = torch.sqrt(var_l * var_r)
    ok = denom > 1e-12
    out["stereo_corr_centered"] = torch.where(
        ok, torch.clamp(cov / torch.where(ok, denom, torch.ones_like(denom)), -1.0, 1.0), torch.ones_like(denom)
    )
    out["stereo_balance"] = (st[7] - st[8]) / nn
    out["mid_rms"] = torch.sqrt(st[9] / nn)
    out["side_rms"] = torch.sqrt(st[10] / nn)

    sl = stft_op(left_ch, n_fft, hop)[:, :f_ext]
    sr_spec = stft_op(right_ch, n_fft, hop)[:, :f_ext]
    mid_e = torch.where(own_cols, torch.abs(0.5 * (sl + sr_spec)) ** 2, zero)
    side_e = torch.where(own_cols, torch.abs(0.5 * (sl - sr_spec)) ** 2, zero)
    freqs_t = torch.as_tensor(freqs, dtype=torch.float32, device=dev)
    nyq = sr / 2.0
    band_masks = [
        ((freqs_t >= lo_f) & (freqs_t <= hi_f))[:, None]
        for lo_f, hi_f in ((0.0, min(200.0, nyq)), (200.0, min(2000.0, nyq)), (2000.0, nyq))
    ]
    band_e = mesh.psum(
        torch.stack([torch.where(b, e, zero).sum() for b in band_masks for e in (mid_e, side_e)]), g
    )
    widths = []
    for k, bmask in enumerate(band_masks):
        nb = torch.clamp_min(bmask.sum(), 1) * lt_den
        m, s = band_e[2 * k] / nb, band_e[2 * k + 1] / nb
        quiet = m <= 1e-12
        widths.append(torch.where(quiet, zero, torch.sqrt(s / torch.where(quiet, torch.ones_like(m), m))))
    out["stereo_widths"] = torch.stack(widths)
    out["f_valid"] = torch.tensor(float(f_valid), device=dev)
    return out


def sharded_track_outputs(stereo: np.ndarray, n_valid: int, sr: int, group: SeqGroup) -> Dict[str, np.ndarray]:
    """Run the sequence-sharded analysis on every rank of ``group`` (each
    passes the whole (2, n) ``stereo``); returns the substrate's output
    dict as numpy on every rank, framewise arrays at full padded length
    (shards x frames per shard)."""

    from .batch import _bundled_net

    g = group
    hop = DEFAULT_CONFIG.hop_length
    fs = frames_per_shard(n_valid, g.size, hop)
    hf = _halo_frames(sr, hop)
    if fs < hf:
        raise ValueError(
            f"track too short for {g.size} seq shards: {fs} frames/shard "
            f"< halo {hf}; use fewer shards or the fused single-device path"
        )
    own = fs * hop
    local = np.zeros((2, own), dtype=np.float32)
    part = np.asarray(stereo, dtype=np.float32)[:, g.rank * own : (g.rank + 1) * own]
    local[:, : part.shape[-1]] = part
    with torch.inference_mode():
        out = _local_track_analysis(
            torch.from_numpy(local).to(g.device),
            int(n_valid),
            sr=sr,
            frames_per_shard=fs,
            g=g,
            net=_bundled_net(g.device),
        )
        out = {k: v.cpu().numpy() for k, v in out.items()}
    return out


def analyse_track_sharded(audio, group: SeqGroup, *, seed: int = DEFAULT_SEED):
    """The full ``TrackAnalysisResult`` of ONE long track sharded over the
    ranks of ``group``. Every rank calls it with the whole ``AudioInput``
    and returns the same result.

    The short-term / momentary RMS curves are the only pieces computed on
    the host (one cumulative sum; their hops do not align with the shard
    boundaries)."""

    from .batch import result_from_graph_outputs

    stereo = (
        audio.stereo_samples if audio.stereo_samples is not None else np.stack([audio.samples, audio.samples])
    ).astype(np.float32)
    n = int(len(audio.samples))
    out = sharded_track_outputs(stereo, n, audio.sample_rate, group)

    # Host: sliding RMS-dB curves via one cumulative sum.
    y = np.asarray(audio.samples, dtype=np.float64)
    cs = np.concatenate([[0.0], np.cumsum(y * y)])

    def rms_db(seconds: float) -> np.ndarray:
        fl = max(1024, int(round(audio.sample_rate * seconds)))
        if fl % 2:
            fl += 1
        hp = max(1, fl // 2)
        pad = fl // 2
        total = 1 + n // hp
        starts = np.arange(total) * hp - pad
        lo = np.clip(starts, 0, n)
        hi = np.clip(starts + fl, 0, n)
        rms = np.sqrt((cs[hi] - cs[lo]) / fl)
        db = 20.0 * np.log10(np.maximum(rms + 1e-9, 1e-5))
        return np.maximum(db, db.max() - 80.0)

    out["short_term_db"] = rms_db(3.0)
    out["momentary_db"] = rms_db(0.4)
    return result_from_graph_outputs(audio, out, seed=seed)


def _analyse_rank(group: SeqGroup, audio, seed: int):
    return analyse_track_sharded(audio, group, seed=seed)


def run_sharded(
    audio,
    world_size: int,
    *,
    backend: "str | None" = None,
    device: "str | torch.device" = "cuda",
    seed: int = DEFAULT_SEED,
    timeout_s: float = mesh.DEFAULT_TIMEOUT_S,
):
    """``analyse_track_sharded`` of ``audio`` over ``world_size`` ranks
    started from this process (``mesh.spawn``: spawned processes, a file
    store in a temporary directory); returns rank 0's result. ``backend``
    defaults to nccl on CUDA and gloo on the CPU; rank r runs on
    ``cuda:(r % device_count)`` unless ``device`` names one. A failing rank
    raises with its traceback."""

    return mesh.spawn(
        _analyse_rank, world_size, (audio, seed), backend=backend, device=device, timeout_s=timeout_s
    )[0]
