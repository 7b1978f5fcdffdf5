"""High level orchestration: ``analyse_track`` and ``TrackAnalysisResult``.

The JAX package's signature, result fields and progress-callback stage
names, plus an explicit ``device``. The fused path is the one ported:
one pass of the fused graph on the device, then the host finishers, then
(on request) stem separation and artefact rendering.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Optional

import torch

from . import features, harmony, stereo
from .analysis import beats, loudness, stems, structure
from .config import DEFAULT_SEED
from .device import resolve_device
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

    Not ported yet, and raising NotImplementedError: ``fused=False`` (the
    per-module path).
    """

    if not fused:
        raise NotImplementedError(
            "fused=False is not ported yet: ROADMAP.md Queue 1 item 8 (the per-module path)"
        )
    dev = resolve_device(device)
    audio = source if isinstance(source, AudioInput) else coerce_audio(source)
    if progress_callback:
        progress_callback("audio")

    from .parallel import batch  # local import to avoid a circular dep

    result = batch.analyse_track_fused(audio, seed=seed, transport=transport, device=dev)
    if progress_callback:
        for stage in ("beats", "structure", "loudness", "harmonic", "features", "stereo"):
            progress_callback(stage)

    if use_stems:
        result.stems = stems.separate_stems(audio.path, output_dir, seed=seed, device=dev)
        if progress_callback:
            progress_callback("stems")

    if output_dir is not None:
        from .rendering import outputs  # local import to avoid a circular dep

        outputs.render_all(result, Path(output_dir), device=dev)
        if progress_callback:
            progress_callback("render")

    return result
