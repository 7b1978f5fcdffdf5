"""Single-track analysis through the fused graph, and the host finishers.

``analyse_track_fused`` pads a track to its bucket, uploads it, runs the
fused graph (``substrate.full_track_graph``, ``pack_outputs``, and the
downbeat TCN when its checkpoint is bundled) on one device, reads the
four packed buffers back, and assembles the ``TrackAnalysisResult`` on
the host (``result_from_graph_outputs``). Counterpart of the JAX
package's ``parallel/batch.py`` single-track path; the library sweep is
not ported yet.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch

from .. import harmony as harmony_mod
from .. import tempo as tempo_mod
from ..analysis import beats as beats_mod
from ..analysis import loudness as loudness_mod
from ..analysis import structure as structure_mod
from ..config import DEFAULT_CONFIG, DEFAULT_SEED
from ..device import resolve_device
from ..features import FeatureAnalysis, FeatureSeries, LongTermAverageSpectrum
from ..models import downbeat as downbeat_model
from ..models import downbeat_net
from ..ops.stft import fft_frequencies
from ..pipeline import TrackAnalysisResult
from ..stereo import StereoAnalysis, StereoWidthBands
from ..substrate import bucket_length, full_track_graph, pack_outputs, unpack_outputs
from ..utils import AudioInput, coerce_audio, deterministic_rng

__all__ = ["analyse_track_fused", "result_from_graph_outputs"]

# Transports that exist in the JAX package and are still to be ported,
# with the ROADMAP.md item that brings each.
_UNPORTED_TRANSPORTS = {
    "ms": "ROADMAP.md Queue 1 item 5 (the ms transport)",
    "ms6": "ROADMAP.md Queue 1 item 6 (the remaining transports)",
    "ms5": "ROADMAP.md Queue 1 item 6 (the remaining transports)",
    "int8": "ROADMAP.md Queue 1 item 6 (the remaining transports)",
}


def _rms_hop(sr: int, seconds: float) -> int:
    fl = max(1024, int(round(sr * seconds)))
    if fl % 2:
        fl += 1
    return max(1, fl // 2)


def result_from_graph_outputs(
    audio: AudioInput,
    out: Dict[str, np.ndarray],
    *,
    seed: int = DEFAULT_SEED,
) -> TrackAnalysisResult:
    """Assemble a TrackAnalysisResult from fused-graph outputs (host)."""

    sr = audio.sample_rate
    n = len(audio.samples)
    hop = DEFAULT_CONFIG.hop_length
    f_valid = 1 + n // hop
    duration = n / float(sr)
    rng = deterministic_rng(seed)

    env = np.asarray(out["onset_env"], dtype=np.float64)[:f_valid]

    # --- beats (ac=None -> float64 host autocorrelation) -----------------
    grid, bpm = tempo_mod.grid_and_bpm_from_env(env, None, duration, sr, hop_length=hop)
    tracked_times = tempo_mod.track_beats(
        env,
        sr,
        hop_length=hop,
        bpm=bpm,
        low_energy=np.asarray(out["low_energy"], dtype=np.float64)[:f_valid],
    )
    beat_result = beats_mod.build_beat_analysis(
        bpm, grid["time"], sr, hop_length=hop, grid=grid, tracked_times=tracked_times,
    )

    # --- downbeats (accent + optional net evidence) -----------------------
    net_prob = out.get("net_prob")
    if net_prob is not None:
        net_prob = np.asarray(net_prob, dtype=np.float64)[:f_valid]
    # Drift-following tracked beats are the downbeat time base when the
    # tracker produced a sane sequence; the constant grid otherwise.
    db_base = (
        tracked_times
        if tracked_times is not None and len(tracked_times) >= 8
        else np.asarray(beat_result.beat_times, dtype=float)
    )
    tracked = downbeat_model.decode_from_accent(
        np.asarray(out["beat_energy"], dtype=np.float64)[:f_valid],
        np.asarray(out["low_energy"], dtype=np.float64)[:f_valid],
        np.asarray(db_base, dtype=float),
        sr,
        flux=env,
        net_prob=net_prob,
        chroma=np.asarray(out["chroma_cq"], dtype=np.float64)[:, :f_valid],
    )
    if tracked is not None and tracked.downbeat_times:
        downbeat_result = beats_mod.DownbeatAnalysis(
            downbeat_times=tracked.downbeat_times,
            beat_positions=tracked.beat_positions,
            source=tracked.source,
        )
    else:
        downbeat_result = beats_mod._fallback_downbeats(beat_result)

    # --- structure --------------------------------------------------------
    structure_result = structure_mod.segments_from_curves(
        np.asarray(out["novelty"], dtype=np.float64)[:f_valid],
        np.asarray(out["energy_novelty"], dtype=np.float64)[:f_valid],
        np.asarray(out["perc_col"], dtype=np.float64)[:f_valid],
        np.asarray(out["harm_col"], dtype=np.float64)[:f_valid],
        beat_result,
        sample_rate=sr,
        hop_length=hop,
        duration=duration,
    )

    # --- loudness ---------------------------------------------------------
    st_n = 1 + n // _rms_hop(sr, DEFAULT_CONFIG.short_term_seconds)
    mo_n = 1 + n // _rms_hop(sr, DEFAULT_CONFIG.loudness_block_seconds)
    short_term = np.asarray(out["short_term_db"], dtype=float)[:st_n]
    momentary = np.asarray(out["momentary_db"], dtype=float)[:mo_n]
    lra = float(np.percentile(momentary, 95) - np.percentile(momentary, 5))
    loudness_result = loudness_mod.LoudnessAnalysis(
        integrated_lufs=float(out["integrated_lufs"]),
        short_term_lufs=short_term.tolist(),
        momentary_lufs=momentary.tolist(),
        loudness_range=lra,
        true_peak_dbfs=float(20.0 * np.log10(float(out["true_peak"]) + 1e-12)),
        rms_dbfs=float(20.0 * np.log10(float(out["rms"]) + 1e-12)),
    )

    # --- harmony ----------------------------------------------------------
    keys = [f"{p} major" for p in harmony_mod.PITCH_CLASS_NAMES]
    keys += [f"{p} minor" for p in harmony_mod.PITCH_CLASS_NAMES]
    key_result = harmony_mod._keys_from_scores(
        np.asarray(out["key_scores"], dtype=np.float64), keys
    )
    chroma_cq = np.asarray(out["chroma_cq"], dtype=np.float64)[:, :f_valid]
    chord_hints = harmony_mod._estimate_chords(chroma_cq, beat_result, rng)
    change_points = harmony_mod._detect_chord_changes(chroma_cq, beat_result, chord_hints)

    total = float(out["balance_total"])
    if total > 0:
        balance = harmony_mod.SpectralBalance(
            low_band=float(out["balance_low"]) / total,
            mid_band=float(out["balance_mid"]) / total,
            high_band=float(out["balance_high"]) / total,
        )
    else:
        balance = harmony_mod.SpectralBalance(0.0, 0.0, 0.0)

    if audio.stereo_samples is None:
        stereo_image = harmony_mod.StereoImage(correlation=1.0, balance=0.0)
    else:
        stereo_image = harmony_mod.StereoImage(
            correlation=float(out["stereo_corr_centered"]),
            balance=float(out["stereo_balance"]),
        )

    start_offset = (
        downbeat_result.downbeat_times[0]
        if downbeat_result and downbeat_result.downbeat_times
        else (beat_result.beat_times[0] if beat_result.beat_times else 0.0)
    )
    hook = harmony_mod._generate_midi(
        chroma_cq, beat_result, key_result.best, rng, name="hook", start_offset=start_offset
    )
    bass = harmony_mod._generate_midi(
        chroma_cq,
        beat_result,
        key_result.best,
        rng,
        name="bass",
        octave=-1,
        start_offset=start_offset,
    )
    harmonic_result = harmony_mod.HarmonyAnalysis(
        spectral_balance=balance,
        stereo_image=stereo_image,
        primary_key=key_result.best,
        secondary_key=key_result.second_best,
        chord_hints=chord_hints,
        chord_change_points=change_points,
        hook_suggestion=hook,
        bass_suggestion=bass,
    )

    # --- features ---------------------------------------------------------
    features_result = FeatureAnalysis(
        ltas=LongTermAverageSpectrum(
            frequencies=fft_frequencies(sr, DEFAULT_CONFIG.n_fft),
            magnitude=np.asarray(out["ltas"], dtype=np.float64)[
                : 1 + DEFAULT_CONFIG.n_fft // 2
            ],
        ),
        spectral_centroid=FeatureSeries(
            values=np.asarray(out["centroid"], dtype=np.float64)[:f_valid]
        ),
        spectral_rolloff=FeatureSeries(
            values=np.asarray(out["rolloff"], dtype=np.float64)[:f_valid]
        ),
    )

    # --- stereo -----------------------------------------------------------
    widths = np.asarray(out["stereo_widths"], dtype=np.float64)
    stereo_result = StereoAnalysis(
        mid_rms=float(out["mid_rms"]),
        side_rms=float(out["side_rms"]),
        correlation=float(out["stereo_corr_centered"]),
        width=StereoWidthBands(
            low=float(widths[0]), mid=float(widths[1]), high=float(widths[2])
        ),
    )

    return TrackAnalysisResult(
        audio=audio,
        beat=beat_result,
        downbeat=downbeat_result,
        structure=structure_result,
        loudness=loudness_result,
        harmonic=harmonic_result,
        features=features_result,
        stereo=stereo_result,
    )


def _pad_track(audio: AudioInput, n_bucket: int) -> tuple[np.ndarray, int]:
    """Channel-major (2, n_bucket) float32 payload and n_valid; mono
    tracks duplicate their channel (the downmix then reproduces the mono
    signal exactly)."""

    n = len(audio.samples)
    stereo = np.zeros((2, n_bucket), dtype=np.float32)
    if audio.stereo_samples is not None and audio.stereo_samples.ndim == 2:
        stereo[:, :n] = audio.stereo_samples[:2, :n]
    else:
        stereo[0, :n] = audio.samples
        stereo[1, :n] = audio.samples
    return stereo, n


def _quantise_i16(x: np.ndarray) -> np.ndarray:
    """Truncating float32 -> int16 at full scale 32768 (-96 dBFS
    quantisation), the JAX package's int16 payload bit for bit."""

    buf = np.multiply(x, np.float32(32768.0), dtype=np.float32)
    np.clip(buf, np.float32(-32768.0), np.float32(32767.0), out=buf)
    return buf.astype(np.int16)


_tcn_cache: dict = {}


def _bundled_net(device: torch.device) -> "downbeat_net.DownbeatTCN | None":
    """The bundled downbeat TCN on ``device``, or None when disabled.

    On by default when the bundled checkpoint is a TCN; a GRU checkpoint
    is refused (its serial scan is too slow for the fused path, and the
    port has no GRU). TRACK_ANALYSER_TPU_NET_DOWNBEATS=0 disables."""

    if os.environ.get("TRACK_ANALYSER_TPU_NET_DOWNBEATS") == "0":
        return None
    params = downbeat_model._net_params()
    if params is None or "tcn0_w" not in params:
        return None
    key = (id(params), str(device))
    if key not in _tcn_cache:
        _tcn_cache[key] = downbeat_net.params_from_jax(params).to(device)
    return _tcn_cache[key]


def _core_graph(stereo: torch.Tensor, n_valid: int, *, sr: int) -> tuple:
    """Fused graph + packed outputs (+ the TCN's per-frame P(downbeat)
    when the bundled checkpoint exists)."""

    packed = pack_outputs(full_track_graph(stereo, n_valid, sr=sr))
    net = _bundled_net(stereo.device)
    if net is not None:
        prob = downbeat_net.activation_graph(net, stereo.mean(dim=0), n_valid, sr=sr)
        return packed + (prob,)
    return packed


def analyse_track_fused(
    source: "str | AudioInput",
    *,
    seed: int = DEFAULT_SEED,
    bucket: bool = True,
    transport: str = "auto",
    device: "str | torch.device" = "cuda",
) -> TrackAnalysisResult:
    """Single-track analysis through the fused graph on ``device``.

    ``device`` defaults to "cuda" and raises if CUDA is absent; pass
    "cpu" for the plain PyTorch path.

    ``transport`` picks the host->device representation:
      - "float32": the exact samples.
      - "int16": -96 dBFS quantisation (lossless for PCM16 sources); half
        the upload bytes.
      - "auto": "float32" in the port for now. (In the JAX package "auto"
        means the blockwise mid/side "ms" transport, which is still to be
        ported, like "ms6", "ms5" and "int8"; those raise
        NotImplementedError.)
    """

    dev = resolve_device(device)
    if transport == "auto":
        transport = "float32"
    if transport in _UNPORTED_TRANSPORTS:
        raise NotImplementedError(
            f"transport {transport!r} is not ported yet: {_UNPORTED_TRANSPORTS[transport]}"
        )
    if transport not in ("float32", "int16"):
        raise ValueError(f"unknown transport {transport!r}")

    audio = source if isinstance(source, AudioInput) else coerce_audio(source)
    n = len(audio.samples)
    n_bucket = bucket_length(n) if bucket else n
    stereo_np, n_valid = _pad_track(audio, n_bucket)
    with torch.inference_mode():
        if transport == "int16":
            payload = torch.from_numpy(_quantise_i16(stereo_np)).to(dev)
            stereo = payload.to(torch.float32) / 32768.0
        else:
            stereo = torch.from_numpy(stereo_np).to(dev)
        fetched = [t.cpu().numpy() for t in _core_graph(stereo, n_valid, sr=audio.sample_rate)]
    out_dict = unpack_outputs(*fetched[:4])
    if len(fetched) > 4:
        out_dict["net_prob"] = fetched[4]
    return result_from_graph_outputs(audio, out_dict, seed=seed)
