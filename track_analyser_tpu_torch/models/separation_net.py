"""Band-split spectral mask network for 4-stem separation, as an ``nn.Module``.

Counterpart of the JAX reference's ``models/separation_net.py`` serving
path:

  STFT(2048/512) -> split bins into log-spaced bands -> per-band linear
  encoders (tanh) -> N mixing blocks (dilated depthwise time conv, kernel
  5, + pointwise + GELU, then band mixing + GELU, both residual) ->
  per-stem complex mask decoders -> masked ISTFT.

Depth, width and band count are read from the checkpoint's arrays, so the
same forward serves every bundled checkpoint (v1-v4: width 96, two
blocks; v5: width 144, four blocks with dilations 1, 3, 9, 27). Channels
are a leading batch axis (the reference's ``vmap``); features are laid out
(..., T, bands, D), time before bands as in the reference. Everything is
plain PyTorch: ``torch.fft``, ``torch.matmul`` per band, shifted slices
for the depthwise conv. ``init_params`` draws a new net with the JAX
module's shapes and scales, ``params_to_jax`` / ``save_checkpoint`` write
one in the JAX checkpoint layout; the training scaffold is
``models/training.py``.
"""

from __future__ import annotations

import math
from functools import lru_cache
from pathlib import Path
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import check_nans, resolve_device
from ..ops.stft import istft, stft

__all__ = [
    "STEMS",
    "band_edges",
    "BandSplitMaskNet",
    "params_from_jax",
    "forward_masks",
    "separate_signal",
    "separate_signal_multi",
    "checkpoint_dilations",
    "load_checkpoint",
    "run_from_checkpoint",
    "init_params",
    "params_to_jax",
    "save_checkpoint",
]

STEMS = ("drums", "bass", "other", "vocals")
N_FFT = 2048
HOP = 512
N_BINS = 1 + N_FFT // 2
_TCONV_TAPS = 5


@lru_cache(maxsize=1)
def band_edges(n_bands: int = 16, n_bins: int = N_BINS) -> Tuple[Tuple[int, int], ...]:
    """Log-spaced frequency band boundaries covering all bins (15 bands
    for the default 16: two rounded edges coincide)."""

    edges = np.unique(np.round(np.geomspace(1, n_bins, n_bands + 1)).astype(int))
    edges[0] = 0
    edges[-1] = n_bins
    return tuple((int(lo), int(hi)) for lo, hi in zip(edges[:-1], edges[1:]) if hi > lo)


class BandSplitMaskNet(nn.Module):
    """The mask net. Parameters carry the checkpoint's own names
    (``enc{b}_w``, ``blk{i}_tconv``, ``dec{b}_{stem}_w``, ...) and shapes
    (every matrix is an ``x @ W`` matrix); ``dilations`` holds one tap
    spacing per mixing block."""

    def __init__(
        self, *, d_model: int, n_blocks: int, dilations: "Tuple[int, ...] | None" = None,
        n_bands: int = 16,
    ) -> None:
        super().__init__()
        self.bands = band_edges(n_bands)
        self.dilations = tuple(int(d) for d in dilations) if dilations else (1,) * n_blocks
        if len(self.dilations) != n_blocks:
            raise ValueError(f"{len(self.dilations)} dilations for {n_blocks} blocks")
        shapes: Dict[str, tuple] = {}
        for b, (lo, hi) in enumerate(self.bands):
            width = hi - lo
            shapes[f"enc{b}_w"] = (2 * width, d_model)
            shapes[f"enc{b}_b"] = (d_model,)
            for stem in STEMS:
                shapes[f"dec{b}_{stem}_w"] = (d_model, 2 * width)
                shapes[f"dec{b}_{stem}_b"] = (2 * width,)
        for blk in range(n_blocks):
            shapes[f"blk{blk}_tconv"] = (_TCONV_TAPS, d_model)
            shapes[f"blk{blk}_tmix_w"] = (d_model, d_model)
            shapes[f"blk{blk}_tmix_b"] = (d_model,)
            shapes[f"blk{blk}_bmix_w"] = (len(self.bands), len(self.bands))
        self.p = nn.ParameterDict(
            {name: nn.Parameter(torch.zeros(shape)) for name, shape in shapes.items()}
        )

    def encode(self, spec: torch.Tensor) -> torch.Tensor:
        """spec (..., bins, T) complex -> features (..., T, n_bands, D)."""

        feats = []
        for b, (lo, hi) in enumerate(self.bands):
            seg = spec[..., lo:hi, :]
            x = torch.cat([seg.real, seg.imag], dim=-2).transpose(-1, -2)  # (..., T, 2*width)
            feats.append(torch.tanh(torch.matmul(x, self.p[f"enc{b}_w"]) + self.p[f"enc{b}_b"]))
        return torch.stack(feats, dim=-2)

    def mixing_block(self, blk: int, h: torch.Tensor) -> torch.Tensor:
        """(..., T, B, D): dilated depthwise time conv + pointwise, then
        band mixing, both residual. The conv is a cross-correlation with
        zero padding 2 * dil on both sides:
        conv[t] = sum_j k[j] * h[t + (j - 2) * dil]."""

        dil = self.dilations[blk]
        k = self.p[f"blk{blk}_tconv"]
        total = h.shape[-3]
        pad = (_TCONV_TAPS // 2) * dil
        hp = F.pad(h, (0, 0, 0, 0, pad, pad))
        conv = k[0] * hp[..., :total, :, :]
        for j in range(1, _TCONV_TAPS):
            conv = conv + k[j] * hp[..., j * dil : j * dil + total, :, :]
        t = F.gelu(
            torch.matmul(conv, self.p[f"blk{blk}_tmix_w"]) + self.p[f"blk{blk}_tmix_b"],
            approximate="tanh",
        )
        h = h + t
        # band mixing: bm[..., c, d] = sum_b h[..., b, d] * W[b, c]
        bm = torch.matmul(self.p[f"blk{blk}_bmix_w"].T, h)
        return h + F.gelu(bm, approximate="tanh")

    def features(self, spec: torch.Tensor, f_valid=None) -> torch.Tensor:
        """Encoder + mixing blocks: (..., bins, T) -> (..., T, n_bands, D).
        Frames at or beyond ``f_valid`` are zeroed after the encoder and
        after every block."""

        fmask = None
        if f_valid is not None:
            fmask = (torch.arange(spec.shape[-1], device=spec.device) < f_valid)[:, None, None]
        zero = torch.zeros((), dtype=torch.float32, device=spec.device)
        h = self.encode(spec)
        if fmask is not None:
            h = torch.where(fmask, h, zero)
        for blk in range(len(self.dilations)):
            h = self.mixing_block(blk, h)
            if fmask is not None:
                h = torch.where(fmask, h, zero)
        return h

    def decode_mask(self, h: torch.Tensor, stem: str) -> torch.Tensor:
        """One stem's complex mask (..., bins, T) from the features, band
        by band."""

        parts = []
        for b, (lo, hi) in enumerate(self.bands):
            width = hi - lo
            y = torch.matmul(h[..., b, :], self.p[f"dec{b}_{stem}_w"]) + self.p[f"dec{b}_{stem}_b"]
            parts.append(torch.complex(y[..., :width], y[..., width:]).transpose(-1, -2))
        return torch.cat(parts, dim=-2)

    def forward(self, spec: torch.Tensor, f_valid=None) -> Dict[str, torch.Tensor]:
        h = self.features(spec, f_valid)
        return {stem: self.decode_mask(h, stem) for stem in STEMS}


def checkpoint_dilations(params: Dict[str, np.ndarray]) -> "Tuple[int, ...] | None":
    """A checkpoint's dilation schedule (None = all ones). "_dilations" is
    architecture metadata, not a weight."""

    d = params.get("_dilations")
    if d is None:
        return None
    return tuple(int(x) for x in np.asarray(d).reshape(-1))


def load_checkpoint(path: "str | Path") -> Dict[str, np.ndarray]:
    """A checkpoint's arrays as numpy (the JAX package's .npz layout)."""

    with np.load(path) as data:
        return {k: np.asarray(data[k]) for k in data.files}


def params_from_jax(params: Dict[str, np.ndarray]) -> BandSplitMaskNet:
    """A ``BandSplitMaskNet`` carrying the JAX parameters.

    Width and depth come from the arrays (``blk{i}_tconv`` is (5, D), one
    per block), the dilations from "_dilations" when the dict holds it.
    Every array keeps its name and its ``x @ W`` layout."""

    n_blocks = sum(1 for k in params if k.startswith("blk") and k.endswith("_tconv"))
    d_model = int(np.asarray(params["blk0_tconv"]).shape[1])
    model = BandSplitMaskNet(
        d_model=d_model, n_blocks=n_blocks, dilations=checkpoint_dilations(params)
    )
    weights = {k: v for k, v in params.items() if k != "_dilations"}
    if set(weights) != set(model.p.keys()):
        odd = sorted(set(weights) ^ set(model.p.keys()))
        raise ValueError(f"checkpoint and network disagree on parameters: {odd[:6]}")
    with torch.no_grad():
        for name, value in weights.items():
            value = torch.as_tensor(np.asarray(value, dtype=np.float32))
            if value.shape != model.p[name].shape:
                raise ValueError(
                    f"{name}: checkpoint shape {tuple(value.shape)}, "
                    f"network shape {tuple(model.p[name].shape)}"
                )
            model.p[name].copy_(value)
    return model.eval()


def _glorot(shape: tuple, generator: torch.Generator) -> torch.Tensor:
    return torch.randn(shape, generator=generator) * math.sqrt(2.0 / (shape[0] + shape[-1]))


def init_params(
    *,
    n_bands: int = 16,
    d_model: int = 96,
    n_blocks: int = 2,
    dilations: "Tuple[int, ...] | None" = None,
    generator: "torch.Generator | None" = None,
) -> BandSplitMaskNet:
    """A new mask net with the JAX ``init_params``'s keys, shapes and
    scales: Glorot-normal encoders, decoders, pointwise and band-mixing
    matrices, 0.1 x normal depthwise taps, zero biases; drawn from
    ``generator`` (the draws are torch's, not JAX's)."""

    gen = generator if generator is not None else torch.Generator().manual_seed(0)
    model = BandSplitMaskNet(d_model=d_model, n_blocks=n_blocks, dilations=dilations, n_bands=n_bands)
    with torch.no_grad():
        for name, p in model.p.items():
            if name.endswith("_b"):
                p.zero_()
            elif name.endswith("_tconv"):
                p.copy_(0.1 * torch.randn(p.shape, generator=gen))
            else:
                p.copy_(_glorot(tuple(p.shape), gen))
    return model


def params_to_jax(model: BandSplitMaskNet) -> Dict[str, np.ndarray]:
    """The net's parameters as numpy float32 under their JAX names (the
    layouts are the JAX ones already); "_dilations" is not a weight and
    is left out."""

    return {name: p.detach().cpu().numpy().astype(np.float32) for name, p in model.p.items()}


def save_checkpoint(model: BandSplitMaskNet, path: "str | Path") -> None:
    """An .npz in the JAX checkpoint layout, the net's dilation schedule
    under "_dilations" (int64), which both packages read."""

    arrays = params_to_jax(model)
    arrays["_dilations"] = np.asarray(model.dilations, dtype=np.int64)
    np.savez(path, **arrays)


def forward_masks(
    model: BandSplitMaskNet, spec: torch.Tensor, *, f_valid=None
) -> Dict[str, torch.Tensor]:
    """Complex masks per stem, each (..., bins, T).

    ``f_valid`` (optional): number of valid frames when ``spec`` is
    bucket-padded. Invalid frames are zeroed after the encoder and after
    every mixing block, which makes them indistinguishable from the conv's
    own zero padding: the valid frames' masks are then what an exact-shape
    run produces (time mixing is a local conv; nothing else crosses
    frames)."""

    return model(spec, f_valid)


def _separate_body(model: BandSplitMaskNet, y: torch.Tensor, n_samples: int, f_valid=None):
    """(..., n) -> (..., 4, n_samples). Each stem's mask is made, applied
    and inverted before the next one's, so one mask is alive at a time."""

    spec = stft(y, N_FFT, HOP)
    h = model.features(spec, f_valid)
    stems = []
    for stem in STEMS:
        masked = spec * model.decode_mask(h, stem)
        stems.append(istft(masked, N_FFT, HOP, n_samples, f_valid=f_valid))
        del masked
    return torch.stack(stems, dim=-2)


def separate_signal(
    model: BandSplitMaskNet, y: torch.Tensor, *, n_samples: int, f_valid=None
) -> torch.Tensor:
    """Mono signal (n,) -> (4, n_samples) stems via masked ISTFT.
    ``f_valid`` masks bucket padding (see :func:`forward_masks`)."""

    if y.dim() != 1:
        raise ValueError(f"separate_signal takes a mono (n,) signal, got {tuple(y.shape)}")
    with torch.inference_mode():
        return check_nans("models.separation_net._separate_body", _separate_body(model, y, n_samples, f_valid))


def separate_signal_multi(
    model: BandSplitMaskNet, y: torch.Tensor, *, n_samples: int, f_valid=None
) -> torch.Tensor:
    """(C, n) channels -> (C, 4, n_samples) stems, the channels as one
    batch: each is separated with the same weights, stereo in and stereo
    out."""

    if y.dim() != 2:
        raise ValueError(f"separate_signal_multi takes (C, n) channels, got {tuple(y.shape)}")
    with torch.inference_mode():
        return check_nans("models.separation_net._separate_body", _separate_body(model, y, n_samples, f_valid))


def run_from_checkpoint(
    path: "str | Path",
    samples: np.ndarray,
    sample_rate: int,
    *,
    seed: int = 0,
    device: "str | torch.device" = "cuda",
) -> Dict[str, np.ndarray]:
    """Stems for (n,) mono or (C, n) multi-channel input, on ``device``;
    values keep the input's channel layout ((n,) or (C, n) per stem).

    The signal is padded to its bucket length and ``f_valid`` masks the
    padding, so the first n output samples are what an exact-shape run
    gives."""

    del sample_rate, seed  # the model is sample-rate agnostic at 44.1k training
    from ..substrate import pad_to_bucket

    dev = resolve_device(device)
    model = params_from_jax(load_checkpoint(path)).to(dev)
    arr = np.asarray(samples, dtype=np.float32)
    n = int(arr.shape[-1])
    padded, f_valid = pad_to_bucket(arr, hop=HOP)
    y = torch.from_numpy(padded).to(dev)
    separate = separate_signal_multi if y.dim() == 2 else separate_signal
    out = separate(model, y, n_samples=padded.shape[-1], f_valid=f_valid)[..., :n].cpu().numpy()
    if y.dim() == 2:
        return {s: out[:, i] for i, s in enumerate(STEMS)}  # out is (C, 4, n)
    return dict(zip(STEMS, out))
