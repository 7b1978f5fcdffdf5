"""High level orchestration: ``analyse_track`` and ``TrackAnalysisResult``.

The JAX package's signature, result fields and progress-callback stage
names, plus an explicit ``device``. The fused path is the one ported:
one pass of the fused graph on the device, then the host finishers.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Optional

import torch

from . import features, harmony, stereo
from .analysis import beats, loudness, structure
from .config import DEFAULT_SEED
from .device import resolve_device
from .utils import AudioInput, coerce_audio

__all__ = ["TrackAnalysisResult", "analyse_track"]


@dataclass
class TrackAnalysisResult:
    """Container aggregating all per-module analysis artefacts.

    ``stems`` stays None: stem separation is not ported yet."""

    audio: AudioInput
    beat: beats.BeatAnalysis
    downbeat: Optional[beats.DownbeatAnalysis]
    structure: structure.StructureAnalysis
    loudness: loudness.LoudnessAnalysis
    harmonic: harmony.HarmonyAnalysis
    features: features.FeatureAnalysis
    stereo: stereo.StereoAnalysis
    stems: None = None


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

    Not ported yet, and raising NotImplementedError: ``output_dir``
    (artefact rendering), ``use_stems=True`` and ``fused=False`` (the
    per-module path).
    """

    if output_dir is not None:
        raise NotImplementedError(
            "output_dir (artefact rendering) is not ported yet: ROADMAP.md Queue 1 item 13"
        )
    if use_stems:
        raise NotImplementedError(
            "use_stems=True is not ported yet: ROADMAP.md Queue 1 item 10 (stems)"
        )
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
    return result
