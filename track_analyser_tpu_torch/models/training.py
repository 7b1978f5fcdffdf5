"""Training scaffold for the band-split separation net.

Counterpart of the JAX package's ``models/training.py``. No dataset ships,
so the separator trains on procedurally synthesised four-stem mixtures
(kick/snare patterns, sub-bass lines, harmonic pads, formant-like
"vocals"): ``synth_stems`` is the JAX module's numpy code, draw for draw.
The loss is an L1 waveform loss plus half an L1 loss of the 1024/256
|STFT|, and the step is Adam (b1 0.9, b2 0.999, eps 1e-8, bias-corrected)
written out over the net's parameters in the JAX module's order of
operations (``torch.optim.Adam`` orders its update differently). The
downbeat net's SGD step is ``models/downbeat_net.train_step``.

``python -m track_analyser_tpu_torch.models.training [--steps 500]
[--batch 8] [--seconds 2.0] [--out separation_ckpt.npz] [--device cuda]``
runs ``train_separation`` and writes the checkpoint in the JAX package's
layout.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import Dict, Tuple

import numpy as np
import torch

from ..ops.stft import stft
from . import separation_net

__all__ = ["synth_stems", "separation_loss", "separation_train_step", "init_opt_state", "train_separation"]

SR = 44_100
_B1, _B2, _EPS = 0.9, 0.999, 1e-8


def synth_stems(rng: np.random.Generator, seconds: float = 2.0) -> np.ndarray:
    """Procedural (4, n) stems: drums / bass / other / vocals."""

    n = int(seconds * SR)
    t = np.arange(n) / SR
    bpm = rng.uniform(90, 135)
    beat = 60.0 / bpm

    drums = np.zeros(n)
    for b in np.arange(0, seconds, beat / 2):
        s = int(b * SR)
        e = min(n, s + int(0.03 * SR))
        drums[s:e] += rng.normal(0, 0.6, e - s) * np.exp(-np.arange(e - s) / (0.004 * SR))
    for b in np.arange(0, seconds, beat):
        s = int(b * SR)
        e = min(n, s + int(0.09 * SR))
        seg = np.arange(e - s) / SR
        drums[s:e] += np.sin(2 * np.pi * (55 + 45 * np.exp(-seg * 70)) * seg) * np.exp(-seg * 35)

    f_bass = rng.uniform(40, 90)
    bass = 0.5 * np.sin(2 * np.pi * f_bass * t) * (np.sin(2 * np.pi * t / 2) > -0.5)

    root = rng.uniform(200, 400)
    other = 0.25 * sum(np.sin(2 * np.pi * root * r * t) for r in (1.0, 1.25, 1.5))

    f0 = rng.uniform(150, 300)
    vib = f0 * (1 + 0.01 * np.sin(2 * np.pi * 5.5 * t))
    phase = 2 * np.pi * np.cumsum(vib) / SR
    vocals = 0.3 * (np.sin(phase) + 0.5 * np.sin(2 * phase) + 0.25 * np.sin(3 * phase))
    vocals *= np.clip(np.sin(2 * np.pi * t / 1.5), 0, 1)

    stems = np.stack([drums, bass, other, vocals]).astype(np.float32)
    peak = np.abs(stems.sum(axis=0)).max() + 1e-6
    return stems / peak * 0.9


def separation_loss(model: separation_net.BandSplitMaskNet, mix, stems) -> torch.Tensor:
    """L1 waveform + 0.5 x L1 of the 1024/256 |STFT|, each a mean over one
    example, then the mean over the batch: ``mix`` (B, n), ``stems``
    (B, 4, n)."""

    dev = next(model.parameters()).device
    mix = torch.as_tensor(mix, dtype=torch.float32, device=dev)
    stems = torch.as_tensor(stems, dtype=torch.float32, device=dev)
    n = mix.shape[-1]
    pred = separation_net._separate_body(model, mix, n)  # (B, 4, n)
    wav_l1 = torch.abs(pred - stems).mean(dim=(-2, -1))
    sp_p = torch.abs(stft(pred, 1024, 256))
    sp_t = torch.abs(stft(stems, 1024, 256))
    spec_l1 = torch.abs(sp_p - sp_t).mean(dim=(-3, -2, -1))
    return (wav_l1 + 0.5 * spec_l1).mean()


def init_opt_state(model: separation_net.BandSplitMaskNet) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor], int]:
    """Adam's (first moments, second moments, step) at zero."""

    zeros = {name: torch.zeros_like(p) for name, p in model.named_parameters()}
    return zeros, {name: torch.zeros_like(p) for name, p in model.named_parameters()}, 0


def separation_train_step(model: separation_net.BandSplitMaskNet, opt_state, mix, stems, lr: float = 3e-4):
    """One Adam step, in place; returns (model, opt_state, loss before
    the step). m <- b1 m + (1 - b1) g, v <- b2 v + (1 - b2) g^2, then
    p <- p - lr * m_hat / (sqrt(v_hat) + eps) with the bias-corrected
    moments, in the JAX step's order."""

    m, v, step = opt_state
    model.zero_grad(set_to_none=True)
    loss = separation_loss(model, mix, stems)
    loss.backward()
    step = step + 1
    c1 = 1.0 - _B1**step
    c2 = 1.0 - _B2**step
    with torch.no_grad():
        for name, p in model.named_parameters():
            g = p.grad
            m[name] = _B1 * m[name] + (1.0 - _B1) * g
            v[name] = _B2 * v[name] + (1.0 - _B2) * g * g
            p.sub_(lr * (m[name] / c1) / (torch.sqrt(v[name] / c2) + _EPS))
    model.zero_grad(set_to_none=True)
    return model, (m, v, step), loss.detach()


def train_separation(
    steps: int = 200,
    *,
    batch: int = 4,
    seconds: float = 1.0,
    seed: int = 0,
    checkpoint_path: "str | Path | None" = None,
    log_every: int = 20,
    device: "str | torch.device" = "cuda",
):
    """Train the band-split separator on procedural mixtures on
    ``device``; returns (model, losses)."""

    from ..device import resolve_device

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    model = separation_net.init_params(generator=torch.Generator().manual_seed(seed)).to(dev)
    opt_state = init_opt_state(model)
    losses = []
    for step in range(steps):
        stems = np.stack([synth_stems(rng, seconds) for _ in range(batch)])
        mix = stems.sum(axis=1)
        model, opt_state, loss = separation_train_step(model, opt_state, mix, stems)
        losses.append(float(loss))
        if log_every and step % log_every == 0:
            print(f"[train_separation] step {step} loss {losses[-1]:.4f}", flush=True)
    if checkpoint_path is not None:
        separation_net.save_checkpoint(model, checkpoint_path)
    return model, losses


def main(argv: "list[str] | None" = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m track_analyser_tpu_torch.models.training",
        description="Train the band-split separator on synthetic mixtures and write its checkpoint.",
    )
    ap.add_argument("--steps", type=int, default=500)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out", type=str, default="separation_ckpt.npz")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    train_separation(args.steps, batch=args.batch, seconds=args.seconds, checkpoint_path=args.out, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
