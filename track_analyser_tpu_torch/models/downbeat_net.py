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
"""

from __future__ import annotations

from typing import Dict

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
    "activation_graph",
    "downbeat_activation",
    "model_for",
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


_model_cache: dict = {}


def model_for(params: Dict[str, np.ndarray], device: torch.device) -> nn.Module:
    """``params_from_jax(params)`` on ``device``, built once per
    (checkpoint, device)."""

    key = (id(params), str(device))
    if key not in _model_cache:
        _model_cache[key] = params_from_jax(params).to(device)
    return _model_cache[key]


def activation_graph(
    model: nn.Module, y: torch.Tensor, n_valid: torch.Tensor, *, sr: int
) -> torch.Tensor:
    """Per-frame P(downbeat) (B, T) over bucket-padded mono lanes (B, n).

    Log-mel features standardised over each lane's valid frames only
    (``n_valid`` (B,)), the TCN over the padded frame axis, softmax
    column 2; padded frames are zeroed in the output."""

    from ..ops.mel import mel_filterbank, melspectrogram_from_power, power_to_db
    from ..ops.stft import magnitude, n_frames

    power = magnitude(y, 2048, _HOP, power=2.0)
    mel_db = power_to_db(
        melspectrogram_from_power(power, mel_filterbank(sr, 2048, 128)), dims=(-2, -1)
    )
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
