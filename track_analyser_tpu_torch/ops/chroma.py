"""Chroma projections (STFT chroma and three-resolution CQ chroma).

Every chroma variant is a filterbank matmul over a static STFT. The
filterbank constructors are numpy code with the JAX reference's arithmetic
(``track_analyser_tpu/ops/chroma.py``), so the constants are
bit-identical:

* ``chroma_stft_filterbank`` reproduces librosa.filters.chroma (Gaussian
  log-frequency windows folded to 12 pitch classes, tuning 0).
* ``cq_chroma_tribank`` is the constant-Q replacement: bass and mid
  octaves projected from two STFTs of one decimated signal, the top
  octaves straight off the shared 2048-family magnitude, jointly
  normalised and summed into one 12-row chroma.
* ``cq_chroma_multires`` is the two-bank variant (a decimated bass bank
  and a full-rate 8192 STFT) and ``cq_chroma_filterbank`` the one-bank
  variant; the analysis does not use them.

Filterbanks are numpy float32; the functions that take a tensor place
them on its device.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

__all__ = [
    "chroma_stft_filterbank",
    "cq_chroma_filterbank",
    "multibank_cq_filterbanks",
    "multires_cq_filterbanks",
    "cq_chroma_multires",
    "cq_chroma_tribank",
    "chroma_from_power",
    "normalize_inf",
]


@lru_cache(maxsize=16)
def chroma_stft_filterbank(
    sr: int,
    n_fft: int,
    n_chroma: int = 12,
    *,
    ctroct: float = 5.0,
    octwidth: float = 2.0,
    base_c: bool = True,
) -> np.ndarray:
    """Gaussian-windowed chroma projection of FFT bins, shape (12, 1+n_fft/2)."""

    a440 = 440.0
    frequencies = np.linspace(0, sr, n_fft, endpoint=False)[1:]
    frqbins = n_chroma * np.log2(frequencies / (a440 / 16.0))
    frqbins = np.concatenate(([frqbins[0] - 1.5 * n_chroma], frqbins))
    binwidthbins = np.concatenate((np.maximum(frqbins[1:] - frqbins[:-1], 1.0), [1.0]))

    d = frqbins[None, :] - np.arange(n_chroma, dtype=np.float64)[:, None]
    n_chroma2 = np.round(n_chroma / 2.0)
    d = np.remainder(d + n_chroma2 + 10 * n_chroma, n_chroma) - n_chroma2

    wts = np.exp(-0.5 * (2.0 * d / binwidthbins[None, :]) ** 2)
    # L2 normalise each FFT bin's chroma distribution
    norms = np.sqrt(np.sum(wts**2, axis=0, keepdims=True))
    wts = wts / np.where(norms > 0, norms, 1.0)

    wts *= np.exp(-0.5 * (((frqbins / n_chroma - ctroct) / octwidth) ** 2))[None, :]
    if base_c:
        wts = np.roll(wts, -3 * (n_chroma // 12), axis=0)
    return wts[:, : 1 + n_fft // 2].astype(np.float32)


@lru_cache(maxsize=16)
def cq_chroma_filterbank(
    sr: int,
    n_fft: int,
    *,
    bins_per_octave: int = 36,
    n_octaves: int = 7,
    fmin: float = 32.703195662574764,  # C1
    n_chroma: int = 12,
) -> np.ndarray:
    """Constant-Q chroma filterbank on FFT bins, shape (12, 1+n_fft/2).

    Each constant-Q channel is a raised-cosine window centred at
    fmin * 2**(k / bins_per_octave) with bandwidth f_k / Q,
    Q = 1 / (2**(1/B) - 1), at least one FFT bin wide; channels fold into
    the nearest pitch class, and each row is L2-normalised."""

    n_bins = bins_per_octave * n_octaves
    fft_freqs = np.linspace(0.0, sr / 2.0, 1 + n_fft // 2)
    q = 1.0 / (2.0 ** (1.0 / bins_per_octave) - 1.0)

    fb = np.zeros((n_chroma, fft_freqs.size), dtype=np.float64)
    bins_per_semitone = bins_per_octave // n_chroma
    for k in range(n_bins):
        fc = fmin * 2.0 ** (k / bins_per_octave)
        if fc >= sr / 2.0:
            break
        bw = max(fc / q, sr / n_fft)
        rel = (fft_freqs - fc) / bw
        window = 0.5 * (1.0 + np.cos(np.pi * np.clip(rel, -1.0, 1.0)))
        window[np.abs(rel) >= 1.0] = 0.0
        ssum = window.sum()
        if ssum <= 0:
            continue
        pc = int(np.round(k / bins_per_semitone)) % n_chroma
        fb[pc] += window / ssum
    row_norm = np.sqrt(np.sum(fb**2, axis=1, keepdims=True))
    fb = fb / np.where(row_norm > 0, row_norm, 1.0)
    return fb.astype(np.float32)


@lru_cache(maxsize=4)
def _hann_tone_shape(n_fft: int, oversample: int = 8) -> np.ndarray:
    """|FT of the periodic hann window| vs bin offset (1.0 at offset 0),
    sampled every 1/oversample bin: the spectral footprint a pure tone
    leaves on the magnitude STFT."""

    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n_fft) / n_fft)
    spec = np.abs(np.fft.rfft(w, oversample * n_fft))
    return (spec / spec[0]).astype(np.float64)


def _tone_normalised_channel(
    freqs: np.ndarray, fc: float, bw: float, res: float, n_fft: int
) -> "np.ndarray | None":
    """Raised-cosine CQ channel over ``freqs``, scaled so a unit-amplitude
    tone at fc yields the same channel output regardless of how many FFT
    bins the channel spans."""

    rel = (freqs - fc) / bw
    window = 0.5 * (1.0 + np.cos(np.pi * np.clip(rel, -1.0, 1.0)))
    window[np.abs(rel) >= 1.0] = 0.0
    ssum = window.sum()
    if ssum <= 0:
        return None
    window /= ssum
    shape = _hann_tone_shape(n_fft)
    oversample = (shape.size - 1) // (n_fft // 2)  # inverse of the pad factor
    idx = np.clip(
        np.round(np.abs(freqs - fc) / res * oversample).astype(int), 0, shape.size - 1
    )
    response = float(np.sum(window * shape[idx]))
    if response <= 1e-9:
        return None
    return window / response


@lru_cache(maxsize=16)
def multibank_cq_filterbanks(
    sr: int,
    specs: tuple,
    *,
    bins_per_octave: int = 36,
    n_octaves: int = 7,
    fmin: float = 32.703195662574764,  # C1
    n_chroma: int = 12,
) -> tuple:
    """N-resolution constant-Q chroma banks, one filterbank per spec.

    Each spec is ``(decim, n_fft, oct_lo, oct_hi)``: constant-Q channels
    whose octave falls in [oct_lo, oct_hi) project from an n_fft-point
    STFT of the ``decim``-fold decimated signal (decim=1 = full rate).
    Channels whose centre exceeds their bank's Nyquist fall through to
    the LAST spec (assumed full-rate). Channel gains are tone-normalised,
    pitch-class row responses flattened at every semitone centre across
    all banks, and the rows scaled by one shared scalar."""

    q = 1.0 / (2.0 ** (1.0 / bins_per_octave) - 1.0)
    banks = []
    for decim, n_fft_eff, oct_lo, oct_hi in specs:
        sr_eff = sr / decim
        banks.append(
            {
                "freqs": np.linspace(0.0, sr_eff / 2.0, 1 + n_fft_eff // 2),
                "n_eff": n_fft_eff,
                "res": sr_eff / n_fft_eff,
                "nyq": sr_eff / 2.0,
                "oct_lo": oct_lo,
                "oct_hi": oct_hi,
            }
        )
    fbs = [np.zeros((n_chroma, b["freqs"].size), dtype=np.float64) for b in banks]
    bins_per_semitone = bins_per_octave // n_chroma

    channels = []  # (pc, bank_idx, fc, window)
    for k in range(bins_per_octave * n_octaves):
        fc = fmin * 2.0 ** (k / bins_per_octave)
        if fc >= sr / 2.0:
            break
        octave = k // bins_per_octave
        bank_idx = len(banks) - 1
        for bi, b in enumerate(banks):
            if b["oct_lo"] <= octave < b["oct_hi"] and fc < b["nyq"]:
                bank_idx = bi
                break
        b = banks[bank_idx]
        bw = max(fc / q, b["res"])  # at least one FFT bin wide
        window = _tone_normalised_channel(b["freqs"], fc, bw, b["res"], b["n_eff"])
        if window is None:
            continue
        # undo the transform's own magnitude scale (|S| peak = A*n_eff/4
        # for periodic hann) so all banks read in the same units
        window = window / (b["n_eff"] / 4.0)
        pc = int(np.round(k / bins_per_semitone)) % n_chroma
        channels.append((pc, bank_idx, fc, window))

    def _footprint(bank: dict, fc: float) -> np.ndarray:
        """|STFT| magnitudes a unit tone at fc leaves on ``bank``'s bins,
        in the shared amplitude units."""

        shape = _hann_tone_shape(bank["n_eff"])
        oversample = (shape.size - 1) // (bank["n_eff"] // 2)
        idx = np.clip(
            np.round(np.abs(bank["freqs"] - fc) / bank["res"] * oversample).astype(int),
            0,
            shape.size - 1,
        )
        return shape[idx] * (bank["n_eff"] / 4.0)

    # Flatten each pitch-class row's response exactly at every semitone
    # centre: the channel scales s nearest 1 (in L2) satisfying
    # sum_i s_i * dot(window_i, footprint(f_j)) = 1 for every probe f_j.
    semis = {}
    for k in range(12 * n_octaves):
        f_k = fmin * 2.0 ** (k / 12.0)
        if f_k >= sr / 2.0:
            break
        semis.setdefault(k % n_chroma, []).append(f_k)
    for pc in range(n_chroma):
        row = [c for c in channels if c[0] == pc]
        probes = semis.get(pc, [])
        if not row or not probes:
            continue
        m = len(row)
        a = np.zeros((len(probes), m), dtype=np.float64)
        for j, f_j in enumerate(probes):
            foots = {}
            for i, (_, bi, _, window) in enumerate(row):
                if bi not in foots:
                    foots[bi] = _footprint(banks[bi], f_j)
                a[j, i] = float(np.dot(window, foots[bi]))
        base = a @ np.ones(m)
        # minimum-norm correction: s = 1 + A^+ (1 - A·1)
        scales = np.ones(m) + np.linalg.pinv(a, rcond=1e-8) @ (1.0 - base)
        if np.any(scales <= 0):
            scales = np.clip(scales, 1e-3, None)
        for s, (rpc, bi, _fc, window) in zip(scales, row):
            fbs[bi][rpc] += s * window

    # One shared scalar: a per-row norm would undo the tone normalisation.
    row_norm = np.sqrt(sum(np.sum(fb**2, axis=1, keepdims=True) for fb in fbs))
    shared = float(np.mean(row_norm)) or 1.0
    return tuple((fb / shared).astype(np.float32) for fb in fbs)


def multires_cq_filterbanks(
    sr: int,
    n_fft_high: int,
    n_fft_low: int,
    decim: int,
    *,
    bins_per_octave: int = 36,
    n_octaves: int = 7,
    low_octaves: int = 3,
    fmin: float = 32.703195662574764,  # C1
    n_chroma: int = 12,
) -> tuple:
    """Two-resolution banks (fb_low, fb_high): the ``low_octaves`` bass
    octaves from an ``n_fft_low`` STFT of the ``decim``-fold decimated
    signal, the rest from a full-rate ``n_fft_high`` STFT."""

    return multibank_cq_filterbanks(
        sr,
        ((decim, n_fft_low, 0, low_octaves), (1, n_fft_high, low_octaves, n_octaves)),
        bins_per_octave=bins_per_octave,
        n_octaves=n_octaves,
        fmin=fmin,
        n_chroma=n_chroma,
    )


def cq_chroma_multires(
    y: torch.Tensor,
    *,
    sr: int,
    n_fft: int = 8_192,
    hop: int = 2_048,
    n_fft_low: int = 4_096,
    decim: int = 16,
    low_octaves: int = 3,
    keep_hz: float = 260.0,
) -> torch.Tensor:
    """Two-resolution CQ chroma (..., 12, 1 + n//hop) of ``y`` (..., n).

    One full-rate STFT for the octaves from ``low_octaves`` up and one
    STFT of the decimated signal for the bass octaves, projected through
    the jointly normalised banks; the decimated hop (hop/decim) keeps
    both frame grids aligned."""

    from .resample import decimate_fir
    from .stft import magnitude

    fb_low, fb_high = multires_cq_filterbanks(sr, n_fft, n_fft_low, decim, low_octaves=low_octaves)
    dev = y.device
    mag_high = magnitude(y, n_fft, hop, power=1.0)
    y_low = decimate_fir(y, decim, sr=sr, keep_hz=keep_hz)
    mag_low = magnitude(y_low, n_fft_low, hop // decim, power=1.0)
    t = min(mag_high.shape[-1], mag_low.shape[-1])
    raw = (
        torch.as_tensor(fb_high, device=dev) @ mag_high[..., :t]
        + torch.as_tensor(fb_low, device=dev) @ mag_low[..., :t]
    )
    return normalize_inf(raw, axis=-2)


def cq_chroma_tribank(
    y: torch.Tensor,
    family_mag: torch.Tensor,
    *,
    sr: int,
    hop: int,
    family_n_fft: int,
    family_hop: int,
    low_n_fft: int = 4_096,
    mid_n_fft: int = 1_024,
    decim: int = 16,
    low_octaves: int = 3,
    family_octave: int = 5,
    n_octaves: int = 7,
    keep_hz: float = 1_050.0,
) -> torch.Tensor:
    """Three-resolution CQ chroma (..., 12, 1 + n//hop) of ``y`` (..., n).

    One ``decim``-fold decimation feeds two STFTs (``low_n_fft`` for the
    bass octaves, ``mid_n_fft`` for the mid octaves); the top octaves
    project off the already-computed ``family_mag`` (hop ``family_hop``),
    sliced every hop/family_hop frames."""

    from .resample import decimate_fir
    from .stft import magnitude

    # Halve the decimation until the decimated Nyquist clears the
    # passband (44.1 kHz -> 16, 22.05 kHz -> 8).
    while decim > 1 and (sr / decim < 2.625 * keep_hz or hop % decim):
        decim //= 2

    fb_low, fb_mid, fb_fam = multibank_cq_filterbanks(
        sr,
        (
            (decim, low_n_fft, 0, low_octaves),
            (decim, mid_n_fft, low_octaves, family_octave),
            (1, family_n_fft, family_octave, n_octaves),
        ),
        n_octaves=n_octaves,
    )
    dev = y.device
    y_low = decimate_fir(y, decim, sr=sr, keep_hz=keep_hz)
    hop_low = hop // decim
    mag_low = magnitude(y_low, low_n_fft, hop_low, power=1.0)
    mag_mid = magnitude(y_low, mid_n_fft, hop_low, power=1.0)
    raw_fam = (torch.as_tensor(fb_fam, device=dev) @ family_mag)[..., :: hop // family_hop]
    t = min(mag_low.shape[-1], mag_mid.shape[-1], raw_fam.shape[-1])
    raw = (
        torch.as_tensor(fb_low, device=dev) @ mag_low[..., :t]
        + torch.as_tensor(fb_mid, device=dev) @ mag_mid[..., :t]
        + raw_fam[..., :t]
    )
    return normalize_inf(raw, axis=-2)


def chroma_from_power(power_spec: torch.Tensor, fb: np.ndarray) -> torch.Tensor:
    """Project a power spectrogram (..., bins, frames) through a chroma
    filterbank and inf-normalise each frame (librosa chroma convention)."""

    raw = torch.as_tensor(fb, device=power_spec.device) @ power_spec
    return normalize_inf(raw, axis=-2)


def normalize_inf(x: torch.Tensor, axis: int = -2) -> torch.Tensor:
    scale = torch.amax(torch.abs(x), dim=axis, keepdim=True)
    return x / torch.where(scale > 0, scale, torch.ones_like(scale))
