"""The fused graph's device work, as plain PyTorch over one padded track.

Everything is taken over the padded bucket the device sees (frames past
the track's end are zeros or fade out), with the track's own frames
``f_valid = 1 + n // 512`` masked, as the graph's padding contract says.
It runs in float64; the precision control runs it in float32 with every
matmul and convolution on TF32 operands. Filterbanks, windows and kernels
are built here from their definitions.
"""

from __future__ import annotations

import contextlib
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from .audio import HOP, N_FFT, hann

N_MELS = 128
N_MFCC = 13
NOVELTY_CONTEXT_S = 2.0
NOVELTY_SIGMA = 1.5
NOVELTY_WEIGHTS = (0.5, 0.3, 0.2)
MEDIAN = 31
TRUE_PEAK_UP = 8


# -- filterbanks ------------------------------------------------------------
def _hz_to_mel(f: np.ndarray) -> np.ndarray:
    """Slaney's mel scale: linear to 1 kHz, logarithmic above."""

    f = np.asarray(f, dtype=np.float64)
    lin = f / (200.0 / 3.0)
    log = 15.0 + np.log(np.maximum(f, 1000.0) / 1000.0) / (np.log(6.4) / 27.0)
    return np.where(f >= 1000.0, log, lin)


def _mel_to_hz(m: np.ndarray) -> np.ndarray:
    m = np.asarray(m, dtype=np.float64)
    return np.where(m >= 15.0, 1000.0 * np.exp((np.log(6.4) / 27.0) * (m - 15.0)), m * (200.0 / 3.0))


def mel_filterbank(sr: int) -> np.ndarray:
    """(128, 1025) triangles between consecutive mel points from 0 Hz to
    Nyquist, each scaled to unit area in Hz (Slaney normalisation)."""

    bins = np.linspace(0.0, sr / 2.0, N_FFT // 2 + 1)
    edges = _mel_to_hz(np.linspace(_hz_to_mel(0.0), _hz_to_mel(sr / 2.0), N_MELS + 2))
    lo, mid, hi = edges[:-2, None], edges[1:-1, None], edges[2:, None]
    rise = (bins[None, :] - lo) / (mid - lo)
    fall = (hi - bins[None, :]) / (hi - mid)
    return np.maximum(0.0, np.minimum(rise, fall)) * (2.0 / (hi - lo))


def dct_ortho(n_out: int, n_in: int) -> np.ndarray:
    """The first ``n_out`` rows of the orthonormal DCT-II."""

    k = np.arange(n_out)[:, None]
    i = np.arange(n_in)[None, :]
    m = np.sqrt(2.0 / n_in) * np.cos(np.pi * k * (2 * i + 1) / (2.0 * n_in))
    m[0] /= np.sqrt(2.0)
    return m


def balance_weights(sr: int, edges=(200.0, 2000.0)) -> np.ndarray:
    """(3, 1025): the share of each bin's band [f - df/2, f + df/2] that
    falls in 0-200 Hz, 200-2000 Hz and above 2 kHz."""

    df = sr / N_FFT
    f = np.linspace(0.0, sr / 2.0, N_FFT // 2 + 1)
    bands = ((0.0, edges[0]), (edges[0], edges[1]), (edges[1], sr / 2.0 + df))
    w = np.stack([np.clip(np.minimum(hi, f + df / 2) - np.maximum(lo, f - df / 2), 0.0, None) for lo, hi in bands])
    return w / np.maximum(w.sum(axis=0, keepdims=True), 1e-12)


def true_peak_phases(up: int = TRUE_PEAK_UP) -> np.ndarray:
    """(21, up): a Kaiser (beta 5) windowed sinc of 20 * up + 1 taps, cut
    off at 1 / up of Nyquist, with gain ``up``, split into its ``up``
    phases; row q holds tap q * up + phase."""

    half = 10 * up
    t = np.arange(2 * half + 1) - half
    h = (1.0 / up) * np.sinc(t / up) * np.kaiser(2 * half + 1, 5.0)
    h = h / h.sum() * up
    rows = -(-h.size // up)
    return np.concatenate([h, np.zeros(rows * up - h.size)]).reshape(rows, up)


def gaussian(sigma: float) -> np.ndarray:
    radius = int(4.0 * sigma + 0.5)
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return k / k.sum()


# -- pieces -------------------------------------------------------------------
def _db(power: torch.Tensor, amin: float = 1e-10, top_db: float = 80.0) -> torch.Tensor:
    db = 10.0 * torch.log10(torch.clamp(power, min=amin))
    return torch.maximum(db, db.max() - top_db)


def _smooth(ar: "_Arith", x: torch.Tensor, sigma: float) -> torch.Tensor:
    """Gaussian smoothing along the last axis, the ends mirrored (the end
    sample not repeated)."""

    k = torch.as_tensor(gaussian(sigma), dtype=x.dtype, device=x.device)
    r = k.numel() // 2
    rows = x.reshape(-1, 1, x.shape[-1])
    return ar.conv(F.pad(rows, (r, r), mode="reflect"), k.view(1, 1, -1)).reshape(x.shape)


def _smooth_to(ar: "_Arith", x: torch.Tensor, f_valid: int, sigma: float) -> torch.Tensor:
    """Smooth as if the curve ended at ``f_valid``: past it, each position
    reads its mirror across the last valid frame."""

    total = x.shape[-1]
    r = gaussian(sigma).size // 2
    i = torch.arange(total + r, device=x.device)
    src = torch.where(i < f_valid, torch.clamp(i, max=total - 1), torch.clamp(2 * f_valid - 2 - i, 0, total - 1))
    return _smooth(ar, x[..., src], sigma)[..., :total]


def _unit_range(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    lo, hi = x[mask].min(), x[mask].max()
    span = hi - lo
    out = torch.zeros_like(x) if span < 1e-9 else (x - lo) / span
    return torch.where(mask, out, torch.zeros_like(x))


def _median(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The median of 31 along ``dim`` of a 2-D array, the ends mirrored."""

    x = x if dim in (-1, 1) else x.T
    out = torch.empty_like(x)
    padded = F.pad(x[None], (MEDIAN // 2, MEDIAN // 2), mode="reflect")[0]
    rows = max(1, (1 << 24) // (x.shape[1] * MEDIAN))
    for s in range(0, x.shape[0], rows):
        out[s : s + rows] = padded[s : s + rows].unfold(-1, MEDIAN, 1).median(dim=-1).values
    return out if dim in (-1, 1) else out.T


def _soft_mask(x: torch.Tensor, other: torch.Tensor) -> torch.Tensor:
    """x^2 / (x^2 + other^2); one half where both are zero."""

    tiny = torch.finfo(x.dtype).tiny
    z = torch.clamp(torch.maximum(x, other), min=tiny)
    a, b = (x / z) ** 2, (other / z) ** 2
    return torch.where(torch.maximum(x, other) < tiny, torch.full_like(x, 0.5), a / (a + b))


def _true_peak(ar: "_Arith", y: torch.Tensor) -> torch.Tensor:
    h = torch.as_tensor(true_peak_phases(), dtype=y.dtype, device=y.device)
    rows = h.shape[0]
    shift = (rows - 1) // 2
    xp = F.pad(y, (rows - 1 - shift, shift))
    windows = xp.unfold(0, rows, 1)  # windows[p, k] = xp[p + k]
    kernel = h.flip(0)
    peak = torch.zeros((), dtype=y.dtype, device=y.device)
    step = 1 << 20
    for s in range(0, y.numel(), step):
        peak = torch.maximum(peak, ar.mm(windows[s : s + step], kernel).abs().max())
    return peak


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to TF32, the tensor cores' input format: the
    10 leading bits of the mantissa, to nearest, ties to even."""

    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x0FFF + ((bits >> 13) & 1)) & ~0x1FFF
    return bits.view(torch.float32)


class _Arith:
    """The arithmetic of a run: float64, or for the precision control
    float32 with every matmul and convolution taking TF32 operands (the
    rounding done here, so that the library's choice of kernel for a
    given shape cannot skip it)."""

    def __init__(self, control: bool):
        self.dtype = torch.float32 if control else torch.float64
        self.round = tf32 if control else (lambda x: x)

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.round(a) @ self.round(b)

    def conv(self, x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
        return F.conv1d(self.round(x), self.round(k))


@contextlib.contextmanager
def _no_tf32():
    cuda, cudnn = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = cuda, cudnn


# -- the graph ----------------------------------------------------------------
@torch.no_grad()
def run(y: np.ndarray, n: int, sr: int, device: str, control: bool = False) -> Dict[str, np.ndarray]:
    """The device outputs the compared fields derive from, for the padded
    mid channel ``y`` with ``n`` valid samples: ``onset_env``, ``novelty``,
    ``centroid`` (each over the track's own frames), ``ltas``,
    ``balance`` (low, mid, high), ``true_peak`` and ``rms``."""

    ar = _Arith(control)
    with _no_tf32():
        as_t = lambda a: torch.as_tensor(np.asarray(a), device=device).to(ar.dtype)  # noqa: E731
        y_t = as_t(y)
        total = 1 + y_t.numel() // HOP
        f_valid = 1 + n // HOP
        t = torch.arange(total, device=device)
        fmask = t < f_valid

        spec = torch.stft(y_t, N_FFT, HOP, window=as_t(hann(N_FFT)), center=True, pad_mode="constant",
                          return_complex=True)
        mag = spec.abs()
        del spec
        power = mag * mag
        mel = ar.mm(as_t(mel_filterbank(sr)), power)

        # onset envelope: the mean positive rise of the mel dB spectrum,
        # delayed by one frame plus half a window
        flux = torch.clamp(torch.diff(_db(mel), dim=1), min=0.0).mean(dim=0)
        env = F.pad(flux, (1 + N_FFT // (2 * HOP), 0))[:total]
        env = torch.where(fmask, env, torch.zeros_like(env))

        # self-similarity: cosine distance between the mean MFCC vectors of
        # the two seconds before and after each frame
        mfcc = _smooth_to(ar, ar.mm(as_t(dct_ortho(N_MFCC, N_MELS)), _db(mel + 1e-9)), f_valid, 1.0)
        ctx = max(2, int(round(NOVELTY_CONTEXT_S * sr / float(HOP))))
        cs = torch.cat([torch.zeros_like(mfcc[:, :1]), torch.cumsum(mfcc, dim=1)], dim=1)
        lo, hi = torch.clamp(t - ctx, 0, total), torch.clamp(t + ctx, 0, total)
        before = (cs[:, t] - cs[:, lo]) / torch.clamp(t - lo, min=1)
        after = (cs[:, hi] - cs[:, t]) / torch.clamp(hi - t, min=1)
        before = before / (torch.linalg.vector_norm(before, dim=0) + 1e-9)
        after = after / (torch.linalg.vector_norm(after, dim=0) + 1e-9)
        sim = 1.0 - (before * after).sum(dim=0)
        sim = torch.where((t >= ctx) & (t < f_valid - ctx), sim, torch.zeros_like(sim))

        # HPSS: soft masks from the medians along time and along frequency
        harm_ref, perc_ref = _median(mag, -1), _median(mag, 0)
        perc = torch.where(fmask, (mag * _soft_mask(perc_ref, harm_ref)).sum(dim=0), torch.zeros_like(env))
        harm = torch.where(fmask, (mag * _soft_mask(harm_ref, perc_ref)).sum(dim=0), torch.zeros_like(env))
        del harm_ref, perc_ref
        ratio = _smooth_to(ar, perc / (perc + harm + 1e-9), f_valid, max(1.0, 0.5 * sr / float(HOP)))
        energy = torch.abs(torch.diff(ratio, prepend=ratio[:1]))

        w_flux, w_sim, w_energy = NOVELTY_WEIGHTS
        combined = (w_flux * _unit_range(env, fmask) + w_sim * _unit_range(sim, fmask)
                    + w_energy * _unit_range(energy, fmask))
        novelty = _smooth_to(ar, combined, f_valid, NOVELTY_SIGMA)

        freqs = as_t(np.linspace(0.0, sr / 2.0, N_FFT // 2 + 1))
        col = mag.sum(dim=0)
        centroid = (freqs[:, None] * (mag / torch.where(col > 0, col, torch.ones_like(col)))).sum(dim=0)
        in_track = (mag * fmask).sum(dim=-1)
        ltas = in_track / f_valid
        balance = ar.mm(as_t(balance_weights(sr)), in_track)

        out = {
            "onset_env": env[:f_valid],
            "novelty": novelty[:f_valid],
            "centroid": centroid[:f_valid],
            "ltas": ltas,
            "balance": balance,
            "true_peak": _true_peak(ar, y_t),
            "rms": torch.sqrt((y_t[:n] * y_t[:n]).sum() / max(n, 1)),
        }
        return {k: v.double().cpu().numpy() for k, v in out.items()}
