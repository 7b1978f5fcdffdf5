"""Downbeat activation networks, as ``nn.Module``s.

Counterpart of the JAX reference's ``models/downbeat_net.py`` inference
path (``forward``, ``tcn_forward``, ``_activation_graph``,
``downbeat_activation``). Two architectures, picked by the checkpoint's
parameter names:

- the time-parallel TCN (``tcn0_w``): an input projection, tanh, seven
  residual blocks (dilated conv over time, kernel 5, SAME padding,
  dilations 1..64, + bias -> GELU (tanh approximation, as
  ``jax.nn.gelu``'s default) -> pointwise projection + bias -> residual
  add), and an output projection to 3 classes (none / beat / downbeat);
- the original GRU stack (``gru0_wx``): an input projection, tanh, two
  GRU layers (gate order r, z, n; the input bias ``b``, no hidden bias),
  and the output projection. ``nn.GRU`` computes the JAX ``_gru_layer``
  with ``weight_ih = wx.T``, ``weight_hh = wh.T``, ``bias_ih = b`` and
  ``bias_hh = 0``. It serves the per-module path; the fused path takes
  it only when TRACK_ANALYSER_TPU_NET_DOWNBEATS=1.

Public layouts follow the JAX functions: features and logits are
(T, channels), or (B, T, channels) for a batch of lanes.

``python -m track_analyser_tpu_torch.models.downbeat_net [--steps 400]
[--batch 8] [--hidden 128] [--out downbeat_ckpt.npz] [--device cuda]``
trains the GRU net (``train_downbeat``) and writes its checkpoint in the
JAX package's layout.
"""

from __future__ import annotations

import argparse
import math
import sys
import threading
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

__all__ = [
    "N_CLASSES",
    "TCN_DILATIONS",
    "TCN_KERNEL",
    "DownbeatTCN",
    "DownbeatGRU",
    "load_checkpoint",
    "params_from_jax",
    "forward",
    "activation_graph",
    "downbeat_activation",
    "model_for",
    "init_params",
    "init_tcn_params",
    "params_to_jax",
    "init_momentum",
    "loss_fn",
    "train_step",
    "save_checkpoint",
    "train_downbeat",
    "synthetic_batch",
    "logmel_features",
    "synth_percussion",
    "synthetic_audio_example",
    "synthetic_audio_batch",
]

N_CLASSES = 3  # none / beat / downbeat
TCN_DILATIONS = (1, 2, 4, 8, 16, 32, 64)
TCN_KERNEL = 5
_HOP = 512


class DownbeatTCN(nn.Module):
    """Per-frame class logits, fully time-parallel: (T, n_mels) -> (T, 3),
    or (B, T, n_mels) -> (B, T, 3) for a batch of lanes."""

    def __init__(self, *, n_mels: int = 128, channels: int = 64) -> None:
        super().__init__()
        self.inp = nn.Linear(n_mels, channels)
        self.convs = nn.ModuleList(
            nn.Conv1d(
                channels, channels, TCN_KERNEL, dilation=d, padding=d * (TCN_KERNEL - 1) // 2
            )
            for d in TCN_DILATIONS
        )
        self.pointwise = nn.ModuleList(nn.Linear(channels, channels) for _ in TCN_DILATIONS)
        self.out = nn.Linear(channels, N_CLASSES)

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        lanes = feats if feats.dim() == 3 else feats[None]
        x = torch.tanh(self.inp(lanes))
        for conv, pointwise in zip(self.convs, self.pointwise):
            h = conv(x.transpose(1, 2)).transpose(1, 2)
            h = F.gelu(h, approximate="tanh")
            x = x + pointwise(h)
        logits = self.out(x)
        return logits if feats.dim() == 3 else logits[0]


class DownbeatGRU(nn.Module):
    """Per-frame class logits of the GRU stack: (T, n_mels) -> (T, 3), or
    (B, T, n_mels) -> (B, T, 3)."""

    def __init__(self, *, n_mels: int = 128, hidden: int = 256) -> None:
        super().__init__()
        self.inp = nn.Linear(n_mels, hidden)
        self.gru = nn.GRU(hidden, hidden, num_layers=2, batch_first=True)
        self.out = nn.Linear(hidden, N_CLASSES)
        for layer in (0, 1):  # the JAX GRU has no recurrent bias
            bias_hh = getattr(self.gru, f"bias_hh_l{layer}")
            with torch.no_grad():
                bias_hh.zero_()
            bias_hh.requires_grad_(False)

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        lanes = feats if feats.dim() == 3 else feats[None]
        x, _ = self.gru(torch.tanh(self.inp(lanes)))
        logits = self.out(x)
        return logits if feats.dim() == 3 else logits[0]


def load_checkpoint(path) -> Dict[str, np.ndarray]:
    """A checkpoint's parameters as numpy arrays (the JAX package's .npz
    layout)."""

    with np.load(path) as data:
        return {k: np.asarray(data[k]) for k in data.files}


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, dtype=np.float32))


def params_from_jax(params: Dict[str, np.ndarray]) -> "DownbeatTCN | DownbeatGRU":
    """The module carrying a JAX checkpoint's parameters: a
    ``DownbeatTCN`` for TCN checkpoints (``tcn0_w``), else a
    ``DownbeatGRU``.

    ``*_in_w`` (n_mels, C), ``tcn{i}_pw`` (C, C) and ``*_out_w`` (C, 3)
    are ``x @ W`` matrices, so ``nn.Linear`` takes their transpose;
    ``tcn{i}_w`` (C_out, C_in, K) is already conv1d's layout;
    ``gru{l}_wx`` / ``gru{l}_wh`` (H, 3H) are ``x @ W`` too, their columns
    the r, z, n gates in ``nn.GRU``'s order.
    """

    if "tcn0_w" not in params:
        return _gru_from_jax(params)
    n_mels, channels = params["tcn_in_w"].shape
    model = DownbeatTCN(n_mels=n_mels, channels=channels)
    with torch.no_grad():
        model.inp.weight.copy_(_t(params["tcn_in_w"]).T)
        model.inp.bias.copy_(_t(params["tcn_in_b"]))
        for i, (conv, pointwise) in enumerate(zip(model.convs, model.pointwise)):
            conv.weight.copy_(_t(params[f"tcn{i}_w"]))
            conv.bias.copy_(_t(params[f"tcn{i}_b"]))
            pointwise.weight.copy_(_t(params[f"tcn{i}_pw"]).T)
            pointwise.bias.copy_(_t(params[f"tcn{i}_pb"]))
        model.out.weight.copy_(_t(params["tcn_out_w"]).T)
        model.out.bias.copy_(_t(params["tcn_out_b"]))
    return model.eval()


def _gru_from_jax(params: Dict[str, np.ndarray]) -> DownbeatGRU:
    n_mels, hidden = params["in_w"].shape
    model = DownbeatGRU(n_mels=n_mels, hidden=hidden)
    with torch.no_grad():
        model.inp.weight.copy_(_t(params["in_w"]).T)
        model.inp.bias.copy_(_t(params["in_b"]))
        for layer in (0, 1):
            getattr(model.gru, f"weight_ih_l{layer}").copy_(_t(params[f"gru{layer}_wx"]).T)
            getattr(model.gru, f"weight_hh_l{layer}").copy_(_t(params[f"gru{layer}_wh"]).T)
            getattr(model.gru, f"bias_ih_l{layer}").copy_(_t(params[f"gru{layer}_b"]))
            getattr(model.gru, f"bias_hh_l{layer}").zero_()
        model.out.weight.copy_(_t(params["out_w"]).T)
        model.out.bias.copy_(_t(params["out_b"]))
    return model.eval()


def _n(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().astype(np.float32)


def params_to_jax(model: "DownbeatTCN | DownbeatGRU") -> Dict[str, np.ndarray]:
    """The JAX checkpoint layout of a net's parameters (numpy float32), the
    inverse of ``params_from_jax``. A GRU whose ``bias_hh`` is not zero
    has no JAX counterpart and raises ``ValueError``."""

    if isinstance(model, DownbeatTCN):
        params = {
            "tcn_in_w": _n(model.inp.weight).T,
            "tcn_in_b": _n(model.inp.bias),
            "tcn_out_w": _n(model.out.weight).T,
            "tcn_out_b": _n(model.out.bias),
        }
        for i, (conv, pointwise) in enumerate(zip(model.convs, model.pointwise)):
            params[f"tcn{i}_w"] = _n(conv.weight)
            params[f"tcn{i}_b"] = _n(conv.bias)
            params[f"tcn{i}_pw"] = _n(pointwise.weight).T
            params[f"tcn{i}_pb"] = _n(pointwise.bias)
        return {k: np.ascontiguousarray(v) for k, v in params.items()}
    params = {
        "in_w": _n(model.inp.weight).T,
        "in_b": _n(model.inp.bias),
        "out_w": _n(model.out.weight).T,
        "out_b": _n(model.out.bias),
    }
    for layer in (0, 1):
        if bool(getattr(model.gru, f"bias_hh_l{layer}").detach().any()):
            raise ValueError(f"bias_hh_l{layer} is not zero: the JAX GRU has no recurrent bias")
        params[f"gru{layer}_wx"] = _n(getattr(model.gru, f"weight_ih_l{layer}")).T
        params[f"gru{layer}_wh"] = _n(getattr(model.gru, f"weight_hh_l{layer}")).T
        params[f"gru{layer}_b"] = _n(getattr(model.gru, f"bias_ih_l{layer}"))
    return {k: np.ascontiguousarray(v) for k, v in params.items()}


def forward(params: Dict[str, "np.ndarray | torch.Tensor"], feats: torch.Tensor) -> torch.Tensor:
    """Per-frame class logits of a checkpoint's net, (T, n_mels) -> (T, 3)
    on ``feats``'s device: the TCN for TCN checkpoints (``tcn0_w``), else
    the GRU stack, as the reference's ``forward`` dispatches. ``params``
    holds the JAX key names, as numpy arrays or tensors. The logits carry
    no autograd graph: training goes through the module of
    ``params_from_jax``."""

    from ..device import resolve_device

    dev = resolve_device(feats.device)  # full float32 on the card (TF32 off)
    host = {
        k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
        for k, v in params.items()
    }
    with torch.no_grad():
        return params_from_jax(host).to(dev)(feats)


_model_cache: dict = {}
_model_lock = threading.Lock()  # sweep workers ask for the net from several threads


def model_for(params: Dict[str, np.ndarray], device: torch.device) -> nn.Module:
    """``params_from_jax(params)`` on ``device``, built once per
    (checkpoint, device)."""

    key = (id(params), str(device))
    with _model_lock:
        if key not in _model_cache:
            # The entry holds ``params`` too, so that its id is not reused.
            _model_cache[key] = (params, params_from_jax(params).to(device))
        return _model_cache[key][1]


def activation_graph(
    model: nn.Module, y: torch.Tensor, n_valid: torch.Tensor, *, sr: int
) -> torch.Tensor:
    """Per-frame P(downbeat) (B, T) over bucket-padded mono lanes (B, n).

    Log-mel features standardised over each lane's valid frames only
    (``n_valid`` (B,)), the TCN over the padded frame axis, softmax
    column 2; padded frames are zeroed in the output."""

    from ..device import device_constant
    from ..ops.mel import mel_filterbank, melspectrogram_from_power, power_to_db
    from ..ops.stft import magnitude, n_frames

    power = magnitude(y, 2048, _HOP, power=2.0)
    fb = device_constant(mel_filterbank, sr, 2048, 128, device=y.device)
    mel_db = power_to_db(melspectrogram_from_power(power, fb), dims=(-2, -1))
    feats = mel_db.transpose(-1, -2)  # (B, T, 128)
    total = n_frames(y.shape[-1], _HOP)
    n_valid = torch.as_tensor(n_valid, device=y.device)
    fmask = torch.arange(total, device=y.device) < (1 + n_valid // _HOP)[:, None]  # (B, T)
    zero = torch.zeros((), dtype=feats.dtype, device=y.device)
    denom = torch.clamp_min(fmask.sum(dim=-1), 1) * feats.shape[-1]
    mu = torch.where(fmask[..., None], feats, zero).sum(dim=(-2, -1)) / denom
    var = torch.where(fmask[..., None], (feats - mu[:, None, None]) ** 2, zero).sum(dim=(-2, -1)) / denom
    feats = (feats - mu[:, None, None]) / (torch.sqrt(var) + 1e-6)[:, None, None]
    logits = model(feats)
    return torch.where(fmask, torch.softmax(logits, dim=-1)[..., 2], zero)


def downbeat_activation(
    params: Dict[str, np.ndarray], samples: np.ndarray, sr: int, *, device="cuda"
) -> np.ndarray:
    """Per-frame P(downbeat) curve (T,) of ``samples`` on ``device``: the
    signal padded to its bucket, one lane of ``activation_graph``, trimmed
    to the valid frames."""

    from ..device import check_nans, resolve_device
    from ..substrate import pad_to_bucket

    dev = resolve_device(device)
    n = len(samples)
    padded, f_valid = pad_to_bucket(np.asarray(samples, dtype=np.float32), hop=_HOP)
    with torch.inference_mode():
        probs = activation_graph(
            model_for(params, dev),
            torch.from_numpy(padded).to(dev)[None],
            torch.tensor([n], device=dev),
            sr=sr,
        )
    return check_nans("models.downbeat_net.activation_graph", probs)[0].cpu().numpy()[:f_valid]


# ---------------------------------------------------------------------------
# Training: initialisation, the class-weighted loss, SGD with momentum.
# ---------------------------------------------------------------------------

_CLASS_WEIGHTS = (1.0, 10.0, 20.0)  # beats and downbeats are rare


def _glorot(shape: tuple, generator: torch.Generator) -> np.ndarray:
    """Glorot-normal draw for a JAX-layout array: fan in ``shape[0]``, fan
    out ``shape[-1]``."""

    scale = math.sqrt(2.0 / (shape[0] + shape[-1]))
    return (torch.randn(shape, generator=generator) * scale).numpy()


def _generator(generator: "torch.Generator | None") -> torch.Generator:
    return generator if generator is not None else torch.Generator().manual_seed(0)


def init_params(
    *, n_mels: int = 128, hidden: int = 256, generator: "torch.Generator | None" = None
) -> DownbeatGRU:
    """A GRU net with the JAX ``init_params``'s shapes and scales
    (Glorot-normal matrices, zero biases), drawn from ``generator`` (the
    draws are torch's, not JAX's)."""

    gen = _generator(generator)
    params = {
        "in_w": _glorot((n_mels, hidden), gen),
        "in_b": np.zeros(hidden, np.float32),
        "out_w": _glorot((hidden, N_CLASSES), gen),
        "out_b": np.zeros(N_CLASSES, np.float32),
    }
    for layer in (0, 1):
        params[f"gru{layer}_wx"] = _glorot((hidden, 3 * hidden), gen)
        params[f"gru{layer}_wh"] = _glorot((hidden, 3 * hidden), gen)
        params[f"gru{layer}_b"] = np.zeros(3 * hidden, np.float32)
    return params_from_jax(params)


def init_tcn_params(
    *, n_mels: int = 128, channels: int = 64, generator: "torch.Generator | None" = None
) -> DownbeatTCN:
    """A TCN with the JAX ``init_tcn_params``'s shapes and scales: Glorot
    projections, He-normal dilated convs (fan ``channels * kernel``), zero
    biases; drawn from ``generator``."""

    gen = _generator(generator)
    params = {
        "tcn_in_w": _glorot((n_mels, channels), gen),
        "tcn_in_b": np.zeros(channels, np.float32),
        "tcn_out_w": _glorot((channels, N_CLASSES), gen),
        "tcn_out_b": np.zeros(N_CLASSES, np.float32),
    }
    for i in range(len(TCN_DILATIONS)):
        fan = channels * TCN_KERNEL
        params[f"tcn{i}_w"] = (
            torch.randn((channels, channels, TCN_KERNEL), generator=gen) * math.sqrt(2.0 / fan)
        ).numpy()
        params[f"tcn{i}_b"] = np.zeros(channels, np.float32)
        params[f"tcn{i}_pw"] = _glorot((channels, channels), gen)
        params[f"tcn{i}_pb"] = np.zeros(channels, np.float32)
    return params_from_jax(params)


def init_momentum(model: nn.Module) -> Dict[str, torch.Tensor]:
    """Zero momentum for every trained parameter of ``model``."""

    return {name: torch.zeros_like(p) for name, p in model.named_parameters() if p.requires_grad}


def _device_of(model: nn.Module) -> torch.device:
    return next(model.parameters()).device


def loss_fn(model: nn.Module, feats_batch, labels_batch) -> torch.Tensor:
    """Class-weighted softmax cross entropy over a batch of (T, n_mels)
    examples, (B, T, n_mels) features and (B, T) labels: sum(ce * w) /
    max(sum(w), 1) with weights 1 / 10 / 20 for none / beat / downbeat."""

    dev = _device_of(model)
    feats = torch.as_tensor(feats_batch, dtype=torch.float32, device=dev)
    labels = torch.as_tensor(labels_batch, device=dev).long()
    logp = torch.log_softmax(model(feats), dim=-1)
    w = torch.as_tensor(_CLASS_WEIGHTS, dtype=torch.float32, device=dev)[labels]
    ce = -logp.gather(-1, labels[..., None])[..., 0]
    return (ce * w).sum() / torch.clamp_min(w.sum(), 1.0)


def train_step(
    model: nn.Module,
    momentum: Dict[str, torch.Tensor],
    feats_batch,
    labels_batch,
    lr: float = 1e-3,
    beta: float = 0.9,
) -> Tuple[nn.Module, Dict[str, torch.Tensor], torch.Tensor]:
    """One SGD-with-momentum step, in place: m <- beta * m + g, then
    p <- p - lr * m for every trained parameter. Returns the model, the
    momentum and the loss before the step."""

    model.train()  # cuDNN runs an RNN's backward only in training mode
    model.zero_grad(set_to_none=True)
    loss = loss_fn(model, feats_batch, labels_batch)
    loss.backward()
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.requires_grad:
                m = momentum[name].mul_(beta).add_(p.grad)
                p.sub_(lr * m)
    model.zero_grad(set_to_none=True)
    return model, momentum, loss.detach()


def save_checkpoint(model: nn.Module, path) -> None:
    """An .npz in the JAX key layout (``params_to_jax``), which both
    packages' ``load_checkpoint`` read."""

    np.savez(path, **params_to_jax(model))


def train_downbeat(
    steps: int = 300,
    *,
    batch: int = 8,
    frames: int = 256,
    hidden: int = 128,
    lr: float = 5e-3,
    seed: int = 0,
    checkpoint_path=None,
    log_every: int = 50,
    device: "str | torch.device" = "cuda",
):
    """Train the GRU activation net on procedural click/accent audio on
    ``device``; returns (model, losses)."""

    from ..device import resolve_device

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    model = init_params(hidden=hidden, generator=torch.Generator().manual_seed(seed)).to(dev)
    momentum = init_momentum(model)
    losses = []
    for step in range(steps):
        feats, labels = synthetic_audio_batch(rng, batch=batch, frames=frames, device=dev)
        model, momentum, loss = train_step(model, momentum, feats, labels, lr)
        losses.append(float(loss))
        if log_every and step % log_every == 0:
            print(f"[train_downbeat] step {step} loss {losses[-1]:.4f}", flush=True)
    if checkpoint_path is not None:
        save_checkpoint(model, checkpoint_path)
    return model, losses


def synthetic_batch(
    rng: np.random.Generator, *, batch: int = 8, frames: int = 256, n_mels: int = 128
) -> Tuple[np.ndarray, np.ndarray]:
    """Abstract click-pattern batch (fast smoke training)."""

    feats = rng.normal(0.0, 0.1, size=(batch, frames, n_mels)).astype(np.float32)
    labels = np.zeros((batch, frames), dtype=np.int32)
    for b in range(batch):
        period = int(rng.integers(28, 48))
        phase = int(rng.integers(0, period))
        meter = int(rng.choice([3, 4]))
        for i, f in enumerate(range(phase, frames, period)):
            is_down = (i % meter) == 0
            labels[b, f] = 2 if is_down else 1
            amp = 3.0 if is_down else 2.0
            feats[b, f, :] += amp * np.exp(-np.arange(n_mels) / 40.0)
            if f + 1 < frames:
                feats[b, f + 1, :] += 0.5 * amp * np.exp(-np.arange(n_mels) / 40.0)
    return feats, labels


# ---------------------------------------------------------------------------
# Real-feature path: the net consumes standardised log-mel frames computed
# by the shared ops, so training audio and inference audio go through the
# same front end.
# ---------------------------------------------------------------------------

_SR = 22_050


def logmel_features(samples: np.ndarray, sr: int = _SR, *, device: "str | torch.device" = "cuda") -> np.ndarray:
    """Standardised log-mel frames (T, 128), the net's input contract,
    computed on ``device``."""

    from ..device import resolve_device
    from ..ops.mel import mel_filterbank, melspectrogram_from_power, power_to_db
    from ..ops.stft import magnitude

    y = torch.as_tensor(np.asarray(samples, dtype=np.float32), device=resolve_device(device))
    with torch.inference_mode():
        power = magnitude(y, 2048, _HOP, power=2.0)
        mel_db = power_to_db(melspectrogram_from_power(power, mel_filterbank(sr, 2048, 128)))
    feats = mel_db.T.cpu().numpy()
    mu, sd = feats.mean(), feats.std() + 1e-6
    return ((feats - mu) / sd).astype(np.float32)


def synth_percussion(
    rng: np.random.Generator,
    *,
    seconds: float = 6.0,
    sr: int = _SR,
    style: "str | None" = None,
    rhythm: "str | None" = None,
    return_downbeat_mask: bool = False,
):
    """Synthesise a percussive pattern; return (audio, beat_times, meter)
    (plus the per-beat downbeat mask when ``return_downbeat_mask``).

    Styles (drawn at random unless pinned): "accent", the downbeat is the
    loudest hit; "backbeat", a quiet kick on the downbeat under loud
    off-beat snares, so that only the kick's timbre marks it. Rhythms:
    "straight" (constant tempo, the first beat a downbeat), "complex"
    (tempo drift up to +-2% a minute, swung off-beat hats, a pickup) and
    "auto" ("complex" with probability 0.5)."""

    n = int(seconds * sr)
    bpm = rng.uniform(80, 160)
    meter = int(rng.choice([3, 4]))
    if style is None:
        style = "backbeat" if rng.random() < 0.4 else "accent"
    if style not in ("accent", "backbeat"):
        raise ValueError(f"unknown percussion style: {style!r}")
    if rhythm is None:
        rhythm = "straight"
    if rhythm == "auto":
        rhythm = "complex" if rng.random() < 0.5 else "straight"
    if rhythm not in ("straight", "complex"):
        raise ValueError(f"unknown rhythm: {rhythm!r}")

    drift = rng.uniform(-0.02, 0.02) if rhythm == "complex" else 0.0  # per minute
    swing_ratio = rng.uniform(0.55, 0.67) if rhythm == "complex" else 0.5
    pickup = int(rng.integers(0, meter)) if rhythm == "complex" else 0

    offset = rng.uniform(0, 60.0 / bpm)
    # Integrate tempo(t) = bpm * (1 + drift * t / 60): each interval uses
    # the local tempo.
    times = []
    t = offset
    while t < seconds - 0.05:
        times.append(t)
        t += 60.0 / (bpm * (1.0 + drift * t / 60.0))
    beat_times = np.asarray(times)
    downbeat_mask = (np.arange(beat_times.size) + pickup) % meter == 0

    y = rng.normal(0, rng.uniform(0.002, 0.02), n).astype(np.float64)
    t_hit = np.arange(int(0.05 * sr)) / sr

    for i, bt in enumerate(beat_times):
        s = int(bt * sr)
        e = min(n, s + t_hit.size)
        is_down = bool(downbeat_mask[i])
        if style == "backbeat":
            amp = rng.uniform(0.35, 0.55) if is_down else rng.uniform(0.8, 1.1)
        else:
            amp = rng.uniform(0.7, 1.0) if is_down else rng.uniform(0.25, 0.55)
        # the kick's timbre marks the downbeat in both styles
        if is_down:
            seg = np.sin(2 * np.pi * (55 + 60 * np.exp(-t_hit * 50)) * t_hit)
        else:
            seg = rng.normal(0, 1.0, t_hit.size) * np.exp(-t_hit * 90)
            seg += 0.5 * np.sin(2 * np.pi * rng.uniform(800, 2000) * t_hit)
        y[s:e] += amp * (seg * np.exp(-t_hit * 25))[: e - s]
        # a swung off-beat hat: an unlabelled event between beats
        if rhythm == "complex" and i + 1 < beat_times.size:
            hs = int((bt + swing_ratio * (beat_times[i + 1] - bt)) * sr)
            he = min(n, hs + t_hit.size // 3)
            if he > hs:
                hat = rng.normal(0, 1.0, he - hs) * np.exp(-np.arange(he - hs) / (0.004 * sr))
                y[hs:he] += rng.uniform(0.15, 0.4) * hat
    # harmonic bed
    y += rng.uniform(0.05, 0.25) * np.sin(2 * np.pi * rng.uniform(80, 300) * np.arange(n) / sr)
    if return_downbeat_mask:
        return y, beat_times, meter, downbeat_mask
    return y, beat_times, meter


def synthetic_audio_example(
    rng: np.random.Generator, *, seconds: float = 6.0, sr: int = _SR, device: "str | torch.device" = "cuda"
) -> Tuple[np.ndarray, np.ndarray]:
    """A synthetic percussive pattern (rhythm "auto") as (feats (T, 128),
    labels (T,)); the frame after each labelled beat carries its label
    too."""

    y, beat_times, _meter, downs = synth_percussion(
        rng, seconds=seconds, sr=sr, rhythm="auto", return_downbeat_mask=True
    )
    feats = logmel_features(y, sr, device=device)
    labels = np.zeros(feats.shape[0], dtype=np.int32)
    for i, bt in enumerate(beat_times):
        f = int(bt * sr / _HOP)
        if 0 <= f < labels.size:
            labels[f] = 2 if downs[i] else 1
            if f + 1 < labels.size and labels[f + 1] == 0:
                labels[f + 1] = labels[f]
    return feats, labels


def synthetic_audio_batch(
    rng: np.random.Generator,
    *,
    batch: int = 8,
    seconds: float = 6.0,
    frames: int = 256,
    sample_rates: Tuple[int, ...] = (_SR,),
    device: "str | torch.device" = "cuda",
) -> Tuple[np.ndarray, np.ndarray]:
    """A batch of synthetic examples cropped to ``frames``. Mixing sample
    rates trains one net across frame rates."""

    pairs = []
    for _ in range(batch):
        sr = int(rng.choice(sample_rates))
        # keep enough audio to fill the frame crop at this rate
        secs = max(seconds, (frames + 2) * _HOP / sr)
        pairs.append(synthetic_audio_example(rng, seconds=secs, sr=sr, device=device))
    feats = np.stack([f[:frames] for f, _ in pairs])
    labels = np.stack([l[:frames] for _, l in pairs])
    return feats, labels


def main(argv: "list[str] | None" = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m track_analyser_tpu_torch.models.downbeat_net",
        description="Train the GRU downbeat net on synthetic audio and write its checkpoint.",
    )
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--hidden", type=int, default=128)
    ap.add_argument("--out", type=str, default="downbeat_ckpt.npz")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    train_downbeat(args.steps, batch=args.batch, hidden=args.hidden, checkpoint_path=args.out, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
