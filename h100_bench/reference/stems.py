"""The four stems ``analyse_track(path, use_stems=True)`` must write, from
the source WAV alone, and how far the written ones are from them.

It follows the JAX package's ``analysis/stems.py`` and
``models/separation_net.py`` (the specification), re-derived here in
numpy and plain PyTorch:

- the source decoded with its channels (16-bit PCM over 32 768), each
  channel separated on its own;
- the band-split mask net: the signal zero-padded to its bucket (eight
  geometric steps an octave, in multiples of 128 hops), a centred Hann
  STFT of 2048 / 512, the bins cut into 15 log-spaced bands, a tanh
  encoder a band, mixing blocks (a dilated five-tap depthwise time
  convolution and a pointwise matrix with tanh-GELU, then a band-mixing
  matrix with tanh-GELU, each residual; frames past the track's own
  ``1 + n // 512`` zeroed after the encoder and after every block), a
  complex mask a stem and band, and the masked spectrum inverted by
  overlap-add over the squared-window sum, frames past the track's own
  left out of both;
- the DSP separator: the same padding and inversion at 4096 / 1024, HPSS
  soft masks from the medians of 31 along time and along frequency, the
  percussive mask for the drums, the harmonic mask under 250 Hz for the
  bass, the harmonic mask from 250 Hz to 8 kHz weighted by each bin's
  temporal modulation (over the track's own frames) for the vocals, and
  what is left, clipped to [0, 1], for the other stem;
- the blend, ``w * net + (1 - w) * dsp`` in float32 with the
  specification's weights, and the PCM_16 quantisation of ``write_wav``
  (``clip(round(x * 32767))`` in float64).

Everything runs in float32 with TF32 off; the precision control
(``control=True``) gives the net's matrix products TF32 operands, rounded
here. Departures from the specification, none of them in what is
computed: the depthwise convolution is ``conv1d`` with groups and a
dilation (the specification sums five shifted products), the overlap-add
is ``fold``, the GELU is written out, and the band mixing is an
``einsum``, so float32 sums run in other orders; the medians are
``unfold`` + ``median`` over row blocks; the inverse transform ignores the
imaginary parts of the DC and Nyquist bins, as the specification's
``irfft`` does and a GPU's C2R transform need not, so they are cleared
first. The checkpoint is read as data from the JAX package's folder; no
module of it, or of the program, is imported.

Two numbers:

- ``stem_lsb``: the largest gap, in 16-bit steps, between a written stem
  and this one, over every stem, channel and frame;
- ``stem_mismatch``: 0 where a written stem has the source's channels and
  frames and lies under the directory its call ran in, and the call names
  the net (``bandsplit-masknet-v5``) as its separator; else 1.
"""

from __future__ import annotations

import math
import wave
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .audio import hann, read_wav
from .graph import _no_tf32, tf32

CHECKPOINT = Path(__file__).resolve().parents[2] / "track_analyser_tpu" / "models" / "checkpoints" / "separation_v5.npz"
MODEL_NAME = "bandsplit-masknet-v5"
STEMS = ("drums", "bass", "other", "vocals")
NET_FFT, NET_HOP = 2048, 512
DSP_FFT, DSP_HOP = 4096, 1024
TAPS = 5
MEDIAN = 31
# the specification's per-stem share of the net in the blend
NET_WEIGHT = {"drums": 0.25, "bass": 0.5, "other": 0.25, "vocals": 0.75}
# the vocals' modulation weight: sigmoid((cv - THETA) * SLOPE)
MOD_THETA, MOD_SLOPE = 0.8, 4.0
PCM_SCALE = 32767.0


# -- the two numbers --------------------------------------------------------------
def stem_lsb(got, ref) -> float:
    """The largest gap between two (C, n) int16 stems, in 16-bit steps;
    1e9 where their shapes differ."""

    got, ref = np.asarray(got), np.asarray(ref)
    if got.shape != ref.shape:
        return 1e9
    if ref.size == 0:
        return 0.0
    gap = np.subtract(got, ref, dtype=np.int32)
    return float(max(gap.max(), -gap.min()))


def stem_mismatch(got, ref) -> float:
    """0 where the written stem has the stated property, else 1."""

    return 0.0 if int(got) == int(ref) else 1.0


LEAVES = {"pcm": "stem_lsb", "layout": "stem_mismatch"}
NUMBERS = {"stem_lsb": stem_lsb, "stem_mismatch": stem_mismatch}


# -- framing ------------------------------------------------------------------------
def bucket(n: int, hop: int) -> int:
    """The length a separator pads ``n`` samples to: eight geometric steps
    an octave from 2**15, rounded up to a multiple of ``hop * 128``."""

    n = max(n, 1 << 15)
    step = int(np.ceil(2.0 ** (int(np.ceil(8.0 * np.log2(n))) / 8.0)))
    quantum = hop * 128
    return -(-step // quantum) * quantum


def _stft(y: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """(C, n) -> (C, 1 + n_fft // 2, 1 + n // hop): centred Hann frames,
    zeros outside the signal."""

    win = torch.as_tensor(hann(n_fft), device=y.device)
    return torch.stft(y, n_fft, hop, window=win, center=True, pad_mode="constant", return_complex=True)


def _istft(spec: torch.Tensor, n_fft: int, hop: int, f_valid: int) -> torch.Tensor:
    """(C, bins, T) -> (C, (T - 1) * hop): each frame's inverse times the
    window, overlap-added and divided by the overlap-added squared window
    (at least 1e-8), the frames from ``f_valid`` on left out of both."""

    c, _bins, total = spec.shape
    win = torch.as_tensor(hann(n_fft), device=spec.device)
    spec = spec.clone()
    spec.imag[:, 0] = 0.0
    spec.imag[:, -1] = 0.0
    frames = torch.fft.irfft(spec, n=n_fft, dim=1) * win[None, :, None]  # (C, n_fft, T)
    frames[:, :, f_valid:] = 0.0
    wsq = (win * win)[None, :, None].expand(1, n_fft, total).clone()
    wsq[:, :, f_valid:] = 0.0
    size = (1, (total - 1) * hop + n_fft)

    def ola(x):
        return F.fold(x, size, kernel_size=(1, n_fft), stride=(1, hop))[:, 0, 0]

    out = ola(frames) / torch.clamp(ola(wsq), min=1e-8)
    return out[:, n_fft // 2 : n_fft // 2 + (total - 1) * hop]


# -- the mask net -----------------------------------------------------------------------
def band_edges(n_bins: int = 1 + NET_FFT // 2, n_bands: int = 16):
    """Log-spaced [lo, hi) bin ranges covering every bin; rounded edges that
    coincide merge, so 16 asked give 15."""

    edges = np.unique(np.round(np.geomspace(1, n_bins, n_bands + 1)).astype(int))
    edges[0], edges[-1] = 0, n_bins
    return [(int(lo), int(hi)) for lo, hi in zip(edges[:-1], edges[1:]) if hi > lo]


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x * x * x)))


class _Net:
    """The checkpoint's arrays on a device, and its forward pass; ``mm``
    is every matrix product (TF32 operands for the control)."""

    def __init__(self, arrays: Dict[str, np.ndarray], device: str, control: bool):
        self.dilations = [int(d) for d in np.asarray(arrays.get("_dilations", [])).reshape(-1)]
        self.w = {k: torch.as_tensor(np.asarray(v, dtype=np.float32), device=device)
                  for k, v in arrays.items() if k != "_dilations"}
        blocks = sum(1 for k in self.w if k.startswith("blk") and k.endswith("_tconv"))
        self.dilations = self.dilations or [1] * blocks
        self.bands = band_edges()
        self.round = tf32 if control else (lambda x: x)

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return torch.matmul(self.round(a), self.round(b))

    def features(self, spec: torch.Tensor, f_valid: int) -> torch.Tensor:
        """(C, bins, T) complex -> (C, T, bands, D)."""

        w = self.w
        h = torch.stack([
            torch.tanh(self.mm(torch.cat([spec[:, lo:hi].real, spec[:, lo:hi].imag], dim=1).transpose(1, 2),
                               w[f"enc{b}_w"]) + w[f"enc{b}_b"])
            for b, (lo, hi) in enumerate(self.bands)], dim=2)
        h[:, f_valid:] = 0.0
        c, t, nb, d = h.shape
        for blk, dil in enumerate(self.dilations):
            # depthwise over time: conv[t] = sum_j k[j] h[t + (j - 2) dil], zeros outside
            k = w[f"blk{blk}_tconv"]  # (taps, D)
            x = h.permute(0, 2, 3, 1).reshape(c * nb, d, t)
            conv = F.conv1d(x, k.T.unsqueeze(1).contiguous(), padding=(TAPS // 2) * dil, dilation=dil, groups=d)
            conv = conv.reshape(c, nb, d, t).permute(0, 3, 1, 2)
            h = h + _gelu(self.mm(conv, w[f"blk{blk}_tmix_w"]) + w[f"blk{blk}_tmix_b"])
            mix = self.round(w[f"blk{blk}_bmix_w"])
            h = h + _gelu(torch.einsum("ctbd,be->cted", self.round(h), mix))
            h[:, f_valid:] = 0.0
        return h

    def mask(self, h: torch.Tensor, stem: str) -> torch.Tensor:
        """(C, T, bands, D) -> the stem's complex mask (C, bins, T)."""

        parts = []
        for b, (lo, hi) in enumerate(self.bands):
            y = self.mm(h[:, :, b], self.w[f"dec{b}_{stem}_w"]) + self.w[f"dec{b}_{stem}_b"]
            parts.append(torch.complex(y[..., : hi - lo], y[..., hi - lo :]).transpose(1, 2))
        return torch.cat(parts, dim=1)


def net_stems(x: torch.Tensor, net: _Net) -> Dict[str, torch.Tensor]:
    """(C, n) float32 -> {stem: (C, n)}: the mask net's estimates."""

    n = x.shape[1]
    padded = F.pad(x, (0, bucket(n, NET_HOP) - n))
    f_valid = 1 + n // NET_HOP
    spec = _stft(padded, NET_FFT, NET_HOP)
    h = net.features(spec, f_valid)
    return {s: _istft(spec * net.mask(h, s), NET_FFT, NET_HOP, f_valid)[:, :n] for s in STEMS}


# -- the DSP separator -----------------------------------------------------------------
def median31(x: torch.Tensor) -> torch.Tensor:
    """The median of 31 along the last axis of (..., L), the ends mirrored
    (the end sample not repeated)."""

    rows = x.reshape(-1, x.shape[-1])
    out = torch.empty_like(rows)
    padded = F.pad(rows[None], (MEDIAN // 2, MEDIAN // 2), mode="reflect")[0]
    step = max(1, (1 << 24) // (rows.shape[1] * MEDIAN))
    for s in range(0, rows.shape[0], step):
        out[s : s + step] = padded[s : s + step].unfold(-1, MEDIAN, 1).median(dim=-1).values
    return out.reshape(x.shape)


def _soft_mask(x: torch.Tensor, other: torch.Tensor) -> torch.Tensor:
    """x^2 / (x^2 + other^2) scaled by the larger; one half where both are
    under float32's smallest normal."""

    tiny = torch.finfo(x.dtype).tiny
    z = torch.clamp(torch.maximum(x, other), min=tiny)
    a, b = (x / z) ** 2, (other / z) ** 2
    return torch.where(torch.maximum(x, other) < tiny, torch.full_like(x, 0.5), a / (a + b))


def dsp_stems(x: torch.Tensor, sr: int) -> Dict[str, torch.Tensor]:
    """(C, n) float32 -> {stem: (C, n)}: the DSP separator's estimates."""

    n = x.shape[1]
    padded = F.pad(x, (0, bucket(n, DSP_HOP) - n))
    f_valid = 1 + n // DSP_HOP
    spec = _stft(padded, DSP_FFT, DSP_HOP)
    mag = spec.abs()
    along_time = median31(mag)
    along_freq = median31(mag.transpose(1, 2).contiguous()).transpose(1, 2)
    harm = mag * _soft_mask(along_time, along_freq)
    perc = mag * _soft_mask(along_freq, along_time)
    del along_time, along_freq
    total = torch.clamp(mag, min=1e-10)
    to_perc, to_harm = perc / total, harm / total

    freqs = torch.as_tensor(np.linspace(0.0, sr / 2.0, 1 + DSP_FFT // 2), device=x.device).to(torch.float32)[:, None]
    low = (freqs < 250.0).to(torch.float32)
    mid = ((freqs >= 250.0) & (freqs < 8000.0)).to(torch.float32)
    own = harm[..., :f_valid]
    count = float(max(f_valid, 1))
    mu = own.sum(dim=-1, keepdim=True) / count
    sd = torch.sqrt(((own - mu) ** 2).sum(dim=-1, keepdim=True) / count)
    voiced = torch.sigmoid((sd / (mu + 1e-8) - MOD_THETA) * MOD_SLOPE)

    masks = {"drums": to_perc, "bass": to_harm * low, "vocals": to_harm * mid * voiced}
    masks["other"] = torch.clamp(1.0 - (masks["drums"] + masks["bass"] + masks["vocals"]), 0.0, 1.0)
    return {s: _istft(spec * masks[s], DSP_FFT, DSP_HOP, f_valid)[:, :n] for s in STEMS}


# -- the answer ---------------------------------------------------------------------------
def pcm16(x: torch.Tensor) -> np.ndarray:
    """``write_wav``'s PCM_16: round(x * 32767) in float64, clipped."""

    return torch.clamp(torch.round(x.double() * PCM_SCALE), -32768, 32767).to(torch.int16).cpu().numpy()


@torch.no_grad()
def stems_pcm(path: str, *, device: str, control: bool = False,
              checkpoint: "str | Path" = CHECKPOINT) -> Dict[str, np.ndarray]:
    """{stem: (C, n) int16}: the blended stems as the call must write them."""

    x_np, sr = read_wav(path)
    with np.load(checkpoint) as data:
        arrays = {k: np.asarray(data[k]) for k in data.files}
    with _no_tf32():
        x = torch.as_tensor(x_np, device=device)
        net = net_stems(x, _Net(arrays, device, control))
        dsp = dsp_stems(x, sr)
        return {s: pcm16(NET_WEIGHT[s] * net[s] + (1.0 - NET_WEIGHT[s]) * dsp[s]) for s in STEMS}


def analyse(path: str, *, device: str, control: bool, checkpoint: "str | Path" = CHECKPOINT) -> dict:
    pcm = stems_pcm(path, device=device, control=control, checkpoint=checkpoint)
    layout: Dict[str, object] = {
        s: {"channels": p.shape[0], "frames": p.shape[1], "in_run_dir": 1} for s, p in pcm.items()}
    layout["model_name"] = 1
    return {"pcm": pcm, "layout": layout}


def read_pcm16(path: "str | Path") -> np.ndarray:
    """A 16-bit PCM WAV's samples as (C, n) int16 (a view of the file's
    interleaved frames)."""

    with wave.open(str(path), "rb") as f:
        if f.getsampwidth() != 2:
            raise ValueError(f"{path}: not 16-bit PCM")
        c = f.getnchannels()
        raw = np.frombuffer(f.readframes(f.getnframes()), dtype="<i2")
    return raw[: raw.size // c * c].reshape(-1, c).T


def served(result, *, source_path: str, run_dir: Optional[Path]) -> dict:
    bundle = result.stems
    pcm, layout = {}, {}
    for s in STEMS:
        path = Path(bundle.stems[s])
        pcm[s] = read_pcm16(path)
        inside = run_dir is not None and path.resolve().is_relative_to(Path(run_dir).resolve())
        layout[s] = {"channels": pcm[s].shape[0], "frames": pcm[s].shape[1], "in_run_dir": int(inside)}
    layout["model_name"] = int(bundle.model_name == MODEL_NAME)
    return {"pcm": pcm, "layout": layout}
