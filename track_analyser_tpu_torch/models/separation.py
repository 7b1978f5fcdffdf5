"""Neural stem separation: checkpoint resolution for the band-split net.

Interface used by ``analysis/stems.py``: ``available()`` reports whether
a trained checkpoint is present; ``separate(samples, sr)`` returns a dict
of named stems, or None without a checkpoint (the DSP separator is then
authoritative). The checkpoints are the JAX package's bundled files, read
from ``track_analyser_tpu/models/checkpoints`` as data (nothing is
imported from that package), newest first, with the same environment
override. The architecture lives in ``models/separation_net.py``.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

MODEL_NAME = "bandsplit-masknet-v5"
_CKPT_ENV = "TRACK_ANALYSER_TPU_SEPARATION_CKPT"
_CKPT_DIR = Path(__file__).resolve().parents[2] / "track_analyser_tpu" / "models" / "checkpoints"
# Newest bundled checkpoint wins (v5: dilated time-conv mixing blocks,
# width 144). The same forward serves all: depth and width are read from
# the arrays.
_BUNDLED = tuple(_CKPT_DIR / f"separation_v{v}.npz" for v in (5, 4, 3, 2, 1))

__all__ = ["available", "model_name", "separate", "MODEL_NAME"]


def _checkpoint_path() -> Optional[Path]:
    path = os.environ.get(_CKPT_ENV)
    if path and Path(path).exists():
        return Path(path)
    return next((p for p in _BUNDLED if p.exists()), None)


def available() -> bool:
    return _checkpoint_path() is not None


def model_name() -> str:
    """Name derived from the RESOLVED checkpoint (env overrides and older
    bundled files report their own version, not the newest's)."""

    path = _checkpoint_path()
    if path is None:
        return MODEL_NAME
    stem = path.stem  # e.g. "separation_v4"
    if stem.startswith("separation_"):
        return f"bandsplit-masknet-{stem.split('_', 1)[1]}"
    return f"bandsplit-masknet-{stem}"


def separate(
    samples: np.ndarray,
    sample_rate: int,
    *,
    seed: int = 0,
    device: "str | torch.device" = "cuda",
) -> Optional[Dict[str, np.ndarray]]:
    """Run the neural separator on ``device`` if a checkpoint is available."""

    ckpt = _checkpoint_path()
    if ckpt is None:
        return None
    from . import separation_net

    return separation_net.run_from_checkpoint(
        ckpt, samples, sample_rate, seed=seed, device=device
    )
