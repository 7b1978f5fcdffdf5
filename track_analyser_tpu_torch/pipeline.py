"""High level orchestration: ``analyse_track`` and ``TrackAnalysisResult``.

The JAX package's signature, result fields and progress-callback stage
names (audio, beats, structure, loudness, harmonic, features, stereo,
stems, render), plus an explicit ``device``. Two paths: the fused one
(one pass of the fused graph on the device, then the host finishers)
and the per-module one (``fused=False``: each module's own graphs, in
the JAX order); then, on request, stem separation and artefact
rendering.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch

from . import features, harmony, stereo, tempo
from .analysis import beats, loudness, stems, structure
from .config import DEFAULT_SEED
from .device import resolve_device
from .profiling import span
from .utils import AudioInput, coerce_audio

__all__ = ["TrackAnalysisResult", "analyse_track"]


@dataclass
class TrackAnalysisResult:
    """Container aggregating all per-module analysis artefacts."""

    audio: AudioInput
    beat: beats.BeatAnalysis
    downbeat: Optional[beats.DownbeatAnalysis]
    structure: structure.StructureAnalysis
    loudness: loudness.LoudnessAnalysis
    harmonic: harmony.HarmonyAnalysis
    features: features.FeatureAnalysis
    stereo: stereo.StereoAnalysis
    stems: Optional[stems.StemBundle] = None


def _beat_stage(audio: AudioInput, device: torch.device) -> tuple[beats.BeatAnalysis, float]:
    """The beat grid from a single envelope pass (the float64 host
    autocorrelation feeds both the BPM and the grid)."""

    y = np.asarray(audio.samples, dtype=np.float32)
    sr = audio.sample_rate
    hop = tempo.DEFAULT_HOP_LENGTH

    env, ac = tempo._envelope_and_autocorr(y, sr, hop, device)
    grid, bpm = tempo.grid_and_bpm_from_env(env, ac, len(y) / float(sr), sr, hop_length=hop)
    beat_result = beats.build_beat_analysis(
        bpm, grid["time"], sr, hop_length=hop, grid=grid,
        tracked_times=beats.tracked_times_for(audio, env, bpm, hop_length=hop, device=device),
    )
    return beat_result, bpm


def analyse_track(
    source: "str | AudioInput",
    *,
    output_dir: "Optional[str | Path]" = None,
    use_stems: bool = False,
    seed: int = DEFAULT_SEED,
    progress_callback: Optional[Callable[[str], None]] = None,
    fused: bool = True,
    transport: str = "auto",
    device: "str | torch.device" = "cuda",
) -> TrackAnalysisResult:
    """Run the deterministic analysis pipeline on ``source`` (a path or a
    preloaded :class:`AudioInput`) on ``device``.

    ``device`` defaults to "cuda" and raises if CUDA is absent; "cpu"
    runs the plain PyTorch path. ``transport``: see
    ``parallel.batch.analyse_track_fused``; "auto" means "ms" (the mid
    channel as blockwise int8, with host-exact stereo values), as in the
    JAX package.

    ``use_stems=True`` separates the source file into four stem WAVs
    (``analysis.stems.separate_stems``; ``result.stems`` is None for a
    source without a path); ``output_dir`` triggers artefact rendering
    (``rendering.outputs.render_all``: report.json, CSVs, HTML, MIDI and
    the plots, which need matplotlib). Both run on ``device``.

    ``fused=False`` runs the per-module graphs (more dispatches, the
    fused path's results within float rounding); ``transport`` applies
    to the fused path only.

    The call is one "call" span, and each host layer inside it a span of
    its own (``profiling.span``): counted in ``stage_seconds()`` always,
    recorded with the track's index 0 under ``torch.profiler``.
    """

    with span("call", track=0):
        dev = resolve_device(device)
        if isinstance(source, AudioInput):
            audio = source
        else:
            with span("decode"):
                audio = coerce_audio(source)
        if progress_callback:
            progress_callback("audio")

        if fused:
            from .parallel import batch  # local import to avoid a circular dep

            result = batch.analyse_track_fused(audio, seed=seed, transport=transport, device=dev)
            if progress_callback:
                for stage in ("beats", "structure", "loudness", "harmonic", "features", "stereo"):
                    progress_callback(stage)
        else:
            result = _analyse_per_module(audio, seed=seed, device=dev, progress_callback=progress_callback)

        if use_stems:
            with span("stems"):
                result.stems = stems.separate_stems(audio.path, output_dir, seed=seed, device=dev)
            if progress_callback:
                progress_callback("stems")

        if output_dir is not None:
            from .rendering import outputs  # local import to avoid a circular dep

            with span("render"):
                outputs.render_all(result, Path(output_dir), device=dev)
            if progress_callback:
                progress_callback("render")

        return result


def _analyse_per_module(
    audio: AudioInput,
    *,
    seed: int,
    device: torch.device,
    progress_callback: Optional[Callable[[str], None]],
) -> TrackAnalysisResult:
    """Each module's own graphs, in the JAX package's order; the stage
    callback fires after each module."""

    def done(stage: str) -> None:
        if progress_callback:
            progress_callback(stage)

    beat_result, _bpm = _beat_stage(audio, device)
    downbeat_result = beats.analyse_downbeats(audio, beat_result, seed=seed, device=device)
    done("beats")
    structure_result = structure.analyse_structure(audio, beat_result, seed=seed, device=device)
    done("structure")
    loudness_result = loudness.analyse_loudness(audio, seed=seed, device=device)
    done("loudness")
    harmonic_result = harmony.analyse_harmony(
        audio, beat_result, downbeat_result, seed=seed, device=device
    )
    done("harmonic")
    feature_result = features.analyse_features(audio, device=device)
    done("features")
    stereo_result = stereo.analyse_stereo(audio, device=device)
    done("stereo")
    return TrackAnalysisResult(
        audio=audio,
        beat=beat_result,
        downbeat=downbeat_result,
        structure=structure_result,
        loudness=loudness_result,
        harmonic=harmonic_result,
        features=feature_result,
        stereo=stereo_result,
    )
