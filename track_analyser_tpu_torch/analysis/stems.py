"""Stem separation (drums / bass / other / vocals).

Counterpart of the JAX package's ``analysis/stems.py``. A deterministic
DSP separator always works: HPSS soft masks (the two medians of 31 run
through the ``median31`` kernel on the card) plus band-limited masking,
inverted back to audio with ``istft``. The band-split mask net
(``models/separation.py``) goes first when a checkpoint is present, and
its stems are blended with the DSP estimates by per-stem weights.

The ladder, and a deliberate deviation. The JAX package swallows every
exception twice (net fails -> DSP; anything fails -> None). Here the
ladder is kept for what it is for: no source path -> None; no checkpoint
-> the DSP separator alone; a file that cannot be read, decoded or
written (``AudioDecodeError``, ``OSError``) -> None. Everything else
propagates: a kernel that does not build or launch, a CUDA error or a
missing card never turns into a DSP result or a None.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from ..config import DEFAULT_SEED
from ..device import check_nans, resolve_device
from ..io.codecs import AudioDecodeError, write_wav
from ..ops.filters import hpss
from ..ops.stft import fft_frequencies, istft, stft

__all__ = ["StemBundle", "separate_stems", "separate_stems_arrays"]

_N_FFT = 4096
_HOP = 1024
_NAMES = ("drums", "bass", "other", "vocals")


@dataclass(slots=True)
class StemBundle:
    stems: Dict[str, Path]
    model_name: str


# Vocals/other split of the harmonic mid band by per-bin temporal
# modulation: voice is syllabically amplitude-modulated (high coefficient
# of variation of |S| over time), pads/organs/keys are steady (low CV).
# The JAX package's grid-searched threshold and slope.
_MOD_THETA = 0.8
_MOD_SLOPE = 4.0


def _dsp_separate_body(y: torch.Tensor, *, sr: int, n_samples: int, f_valid=None) -> torch.Tensor:
    """Mask-based 4-stem split of (n,) or (C, n) audio; returns (4, n) or
    (C, 4, n). Channels are a batch: each is split on its own.

    ``f_valid`` masks bucket padding out of the modulation statistics and
    the ISTFT normaliser."""

    dev = y.device
    spec = stft(y, _N_FFT, _HOP)
    mag = torch.abs(spec)
    harm, perc = hpss(mag, kernel_size=31, power=2.0)
    total = torch.clamp_min(mag, 1e-10)
    mask_perc = perc / total
    mask_harm = harm / total

    freqs = torch.as_tensor(fft_frequencies(sr, _N_FFT), dtype=torch.float32, device=dev)[:, None]
    low = (freqs < 250.0).to(torch.float32)
    mid_band = ((freqs >= 250.0) & (freqs < 8000.0)).to(torch.float32)

    zero = torch.zeros((), dtype=torch.float32, device=dev)
    n_frames = harm.shape[-1]
    if f_valid is None:
        fmask = torch.ones(n_frames, dtype=torch.bool, device=dev)
        count = torch.tensor(float(n_frames), device=dev)
    else:
        fmask = torch.arange(n_frames, device=dev) < f_valid
        count = torch.clamp_min(torch.as_tensor(f_valid, device=dev).to(torch.float32), 1.0)
    mu = torch.where(fmask, harm, zero).sum(dim=-1, keepdim=True) / count
    sd = torch.sqrt(torch.where(fmask, (harm - mu) ** 2, zero).sum(dim=-1, keepdim=True) / count)
    cv = sd / (mu + 1e-8)
    w_voc = torch.sigmoid((cv - _MOD_THETA) * _MOD_SLOPE)

    m_drums = mask_perc
    m_bass = mask_harm * low
    m_vocals = mask_harm * mid_band * w_voc
    m_other = torch.clamp(1.0 - (m_drums + m_bass + m_vocals), 0.0, 1.0)

    stems = [
        istft(spec * mask, _N_FFT, _HOP, n_samples, f_valid=f_valid)
        for mask in (m_drums, m_bass, m_other, m_vocals)
    ]
    return torch.stack(stems, dim=-2)


# Per-stem neural weight for the neural/DSP blend: the JAX package's
# grid-searched values for the bundled v5 checkpoint (the net carries
# vocals, the DSP separator the sustained percussion).
_BLEND_NEURAL_WEIGHT = {"drums": 0.25, "bass": 0.5, "other": 0.25, "vocals": 0.75}


def _blend_with_dsp(
    neural: Dict[str, np.ndarray],
    samples: np.ndarray,
    sample_rate: int,
    *,
    device: "str | torch.device" = "cuda",
) -> Dict[str, np.ndarray]:
    """Combine neural and DSP stem estimates with per-stem weights."""

    if all(w >= 1.0 for w in _BLEND_NEURAL_WEIGHT.values()):
        return neural
    dsp = separate_stems_arrays(samples, sample_rate, device=device)
    out: Dict[str, np.ndarray] = {}
    for name, est in neural.items():
        w = _BLEND_NEURAL_WEIGHT.get(name, 1.0)
        out[name] = est if w >= 1.0 else (w * est + (1.0 - w) * dsp[name]).astype(np.float32)
    return out


def separate_stems_arrays(
    samples: np.ndarray, sample_rate: int, *, device: "str | torch.device" = "cuda"
) -> Dict[str, np.ndarray]:
    """Separate a signal into named stems with the DSP separator, on
    ``device`` (in-memory API).

    ``samples`` may be mono (n,) -> stems of shape (n,), or channel-major
    multi-channel (C, n) -> stems of shape (C, n), separated per channel.
    The signal is padded to its bucket length with ``f_valid`` masking."""

    from ..substrate import pad_to_bucket

    dev = resolve_device(device)
    arr = np.asarray(samples, dtype=np.float32)
    n = int(arr.shape[-1])
    padded, f_valid = pad_to_bucket(arr, hop=_HOP)
    with torch.inference_mode():
        y = torch.from_numpy(padded).to(dev)
        out = _dsp_separate_body(y, sr=sample_rate, n_samples=padded.shape[-1], f_valid=f_valid)
        out = check_nans("analysis.stems._dsp_separate_body", out)[..., :n].cpu().numpy()
    if arr.ndim == 2:
        return {s: out[:, i] for i, s in enumerate(_NAMES)}  # out is (C, 4, n)
    return dict(zip(_NAMES, out))


def separate_stems(
    audio_path: Optional[str],
    output_dir: "Optional[str | Path]",
    *,
    seed: int = DEFAULT_SEED,
    device: "str | torch.device" = "cuda",
) -> Optional[StemBundle]:
    """Write drums/bass/other/vocals WAVs (PCM_16) next to the analysis
    artefacts; the separators run on ``device``.

    Returns a :class:`StemBundle` of the written paths; None when there is
    no source path, or when the source cannot be read or decoded or a stem
    cannot be written. Any other failure propagates (see the module
    docstring): a device or kernel error is never hidden behind the DSP
    separator or a None.
    """

    if audio_path is None:
        return None
    dev = resolve_device(device)

    from ..io.loader import load_audio
    from ..models import separation as separation_model

    # Stereo in, stereo out: stereo sources separate per channel and write
    # 2-channel stem WAVs; mono sources keep the mono path.
    try:
        out_dir = Path(output_dir) if output_dir is not None else Path.cwd() / "stems"
        out_dir.mkdir(parents=True, exist_ok=True)
        samples, sample_rate, _meta = load_audio(audio_path, mono=False)
    except (AudioDecodeError, OSError):
        return None
    samples = np.asarray(samples, dtype=np.float32)
    if samples.ndim == 2 and samples.shape[0] == 1:
        samples = samples[0]

    # Neural path first when a trained checkpoint exists, blended with the
    # DSP estimates (see _blend_with_dsp); the DSP separator alone otherwise.
    if separation_model.available():
        stems = separation_model.separate(samples, sample_rate, seed=seed, device=dev)
        model_name = separation_model.model_name()
        stems = _blend_with_dsp(stems, samples, sample_rate, device=dev)
    else:
        model_name = "hpss-dsp-v1"
        stems = separate_stems_arrays(samples, sample_rate, device=dev)

    stem_paths: Dict[str, Path] = {}
    try:
        for name, data in stems.items():
            path = out_dir / f"{Path(audio_path).stem}_{name}.wav"
            write_wav(path, data, sample_rate, subtype="PCM_16")
            stem_paths[name] = path
    except OSError:
        return None
    return StemBundle(stems=stem_paths, model_name=model_name)
