"""The PyTorch port's ops tier against the JAX package's ops, on the CPU.

Inputs are made with numpy from a seed and handed to both packages.
Numpy filter constructors copied into the port must be bit-exact. Tensor ops
are held at rtol 1e-5 / atol 1e-6 unless a comment beside the tolerance
says why an op needs more (in every such case: a float32 FFT or a long
float32 reduction whose summation order differs between XLA and
PyTorch).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from track_analyser_tpu.ops import chroma as j_chroma
from track_analyser_tpu.ops import filters as j_filters
from track_analyser_tpu.ops import loudness as j_loud
from track_analyser_tpu.ops import mel as j_mel
from track_analyser_tpu.ops import onset as j_onset
from track_analyser_tpu.ops import resample as j_resample
from track_analyser_tpu.ops import spectral as j_spectral
from track_analyser_tpu.ops import stft as j_stft
from track_analyser_tpu_torch.ops import chroma as t_chroma
from track_analyser_tpu_torch.ops import filters as t_filters
from track_analyser_tpu_torch.ops import loudness as t_loud
from track_analyser_tpu_torch.ops import mel as t_mel
from track_analyser_tpu_torch.ops import onset as t_onset
from track_analyser_tpu_torch.ops import resample as t_resample
from track_analyser_tpu_torch.ops import spectral as t_spectral
from track_analyser_tpu_torch.ops import stft as t_stft

torch.set_num_threads(2)

SR = 22_050
RTOL, ATOL = 1e-5, 1e-6


def _signal(n: int, seed: int = 0) -> np.ndarray:
    """Tones + clicks + noise: every op sees real structure."""

    rng = np.random.default_rng(seed)
    t = np.arange(n) / SR
    y = 0.3 * np.sin(2 * np.pi * 220.0 * t) + 0.2 * np.sin(2 * np.pi * 1330.0 * t)
    y += 0.02 * rng.normal(size=n)
    for start in range(0, n, SR // 2):
        y[start : start + 300] += 0.8 * np.exp(-np.arange(min(300, n - start)) / 60.0)
    return y.astype(np.float32)


def _mag(n: int = 3 * SR, seed: int = 0) -> np.ndarray:
    return np.array(j_stft.magnitude(jnp.asarray(_signal(n, seed)), 2048, 512))


def _close(got: torch.Tensor, ref, *, rtol: float = RTOL, atol: float = ATOL) -> None:
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=rtol, atol=atol)


# ---------------------------------------------------------------------------
# Numpy filter constructors: copied arithmetic, bit-exact
# ---------------------------------------------------------------------------

_TRIBANK_SPECS = ((8, 4096, 0, 3), (8, 1024, 3, 5), (1, 2048, 5, 7))

_CONSTRUCTORS = {
    "hann_window": lambda m: m.stft.hann_window(2048),
    "fft_frequencies": lambda m: m.stft.fft_frequencies(SR, 2048),
    "mel_filterbank": lambda m: m.mel.mel_filterbank(SR, 2048, 128),
    "mel_filterbank_44k": lambda m: m.mel.mel_filterbank(44_100, 2048, 128),
    "dct_matrix": lambda m: m.mel.dct_matrix(13, 128),
    "gaussian_kernel": lambda m: m.filters.gaussian_kernel(21.5),
    "chroma_stft_filterbank": lambda m: m.chroma.chroma_stft_filterbank(SR, 2048),
    "multibank_cq_filterbanks": lambda m: np.concatenate(
        m.chroma.multibank_cq_filterbanks(SR, _TRIBANK_SPECS), axis=1
    ),
    "decimation_kernel": lambda m: m.resample._decimation_kernel(SR, 8, 1050.0),
    "decimation_toeplitz": lambda m: m.resample._decimation_toeplitz(44_100, 16, 1050.0, 128),
    "polyphase_filter": lambda m: m.resample.polyphase_filter(8, 1),
    "true_peak_matrix": lambda m: m.resample.true_peak_oversample_matrix(8),
    "k_weighting_fir": lambda m: m.loudness.k_weighting_fir(SR),
    "k_weighting_fir_44k": lambda m: m.loudness.k_weighting_fir(44_100),
    "balance_band_weights": lambda m: m.spectral.balance_band_weights(SR, 2048),
}


@pytest.mark.parametrize("name", sorted(_CONSTRUCTORS))
def test_numpy_filter_constructors_are_bit_exact(name) -> None:
    import track_analyser_tpu.ops as jax_ops
    import track_analyser_tpu_torch.ops as torch_ops

    ref = np.asarray(_CONSTRUCTORS[name](jax_ops))
    got = np.asarray(_CONSTRUCTORS[name](torch_ops))
    assert got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)


# ---------------------------------------------------------------------------
# STFT family
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("center", [True, False])
def test_frame_signal_matches(center) -> None:
    y = _signal(10_000)
    ref = j_stft.frame_signal(jnp.asarray(y), 2048, 512, center=center)
    got = t_stft.frame_signal(torch.from_numpy(y), 2048, 512, center=center)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("n_fft,hop", [(2048, 512), (4096, 256), (1024, 256)])
def test_stft_matches(n_fft, hop) -> None:
    y = np.stack([_signal(3 * SR, 1), _signal(3 * SR, 2)])
    ref = np.asarray(j_stft.stft(jnp.asarray(y), n_fft, hop))
    got = t_stft.stft(torch.from_numpy(y), n_fft, hop).numpy()
    assert got.shape == ref.shape
    # float32 FFTs (pocketfft vs XLA's) round differently: absolute error
    # relative to the largest bin
    scale = np.abs(ref).max()
    np.testing.assert_allclose(got.real, ref.real, rtol=0, atol=2e-6 * scale)
    np.testing.assert_allclose(got.imag, ref.imag, rtol=0, atol=2e-6 * scale)


@pytest.mark.parametrize("power", [1.0, 2.0])
def test_magnitude_matches(power) -> None:
    y = _signal(3 * SR)
    ref = np.asarray(j_stft.magnitude(jnp.asarray(y), 2048, 512, power=power))
    got = t_stft.magnitude(torch.from_numpy(y), 2048, 512, power=power)
    assert got.is_contiguous()
    # FFT rounding, relative to the largest bin (see test_stft_matches)
    _close(got, ref, rtol=0, atol=4e-6 * np.abs(ref).max())


# ---------------------------------------------------------------------------
# Mel / onset
# ---------------------------------------------------------------------------


def test_mel_power_db_mfcc_match() -> None:
    power = _mag() ** 2
    fb = t_mel.mel_filterbank(SR, 2048, 128)
    mel_ref = j_mel.melspectrogram_from_power(jnp.asarray(power), fb)
    mel_got = t_mel.melspectrogram_from_power(torch.from_numpy(power), fb)
    _close(mel_got, mel_ref, atol=1e-6 * float(np.abs(mel_ref).max()))

    mel = np.array(mel_ref)
    db_ref = j_mel.power_to_db(jnp.asarray(mel + 1e-9))
    db_got = t_mel.power_to_db(torch.from_numpy(mel + 1e-9))
    # log10 of float32: the two libraries' log10 differ in the last ulp
    _close(db_got, db_ref, rtol=1e-6, atol=2e-5)

    amp_ref = j_mel.amplitude_to_db(jnp.asarray(np.sqrt(mel)), top_db=80.0)
    amp_got = t_mel.amplitude_to_db(torch.from_numpy(np.sqrt(mel)), top_db=80.0)
    _close(amp_got, amp_ref, rtol=1e-6, atol=2e-5)

    log_mel = np.array(db_ref)
    mfcc_ref = j_mel.mfcc_from_log_mel(jnp.asarray(log_mel), 13)
    mfcc_got = t_mel.mfcc_from_log_mel(torch.from_numpy(log_mel), 13)
    # a 128-term float32 sum of dB values of ~100: summation order
    _close(mfcc_got, mfcc_ref, rtol=1e-5, atol=5e-4)


def test_onset_strength_matches() -> None:
    power = _mag() ** 2
    mel = np.array(j_mel.melspectrogram_from_power(jnp.asarray(power), j_mel.mel_filterbank(SR, 2048)))
    ref = j_onset.onset_strength_from_mel(jnp.asarray(mel), n_fft=2048, hop_length=512)
    got = t_onset.onset_strength_from_mel(torch.from_numpy(mel), n_fft=2048, hop_length=512)
    # differences of dB values (log10 last-ulp) averaged over 128 bands
    _close(got, ref, rtol=1e-5, atol=2e-5)


# ---------------------------------------------------------------------------
# Filters
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sigma", [1.0, 1.5, 5.0, 21.5])
def test_gaussian_filter1d_matches(sigma) -> None:
    """sigma 1.0/1.5/5.0 -> 9/13/41 taps (shifted FMAs, <= 48); 21.5 ->
    173 taps (the FFT branch)."""

    x = np.random.default_rng(3).normal(size=(13, 700)).astype(np.float32)
    for axis in (-1, 0):
        ref = j_filters.gaussian_filter1d(jnp.asarray(x), sigma, axis=axis)
        got = t_filters.gaussian_filter1d(torch.from_numpy(x), sigma, axis=axis)
        # the FFT branch: float32 FFT rounding on unit-scale data
        atol = 2e-6 if t_filters.gaussian_kernel(sigma).size <= 48 else 1e-5
        _close(got, ref, rtol=1e-5, atol=atol)


def test_softmask_matches() -> None:
    rng = np.random.default_rng(4)
    x = np.abs(rng.normal(size=(64, 200))).astype(np.float32)
    ref_x = np.abs(rng.normal(size=(64, 200))).astype(np.float32)
    x[0, :10] = 0.0
    ref_x[0, :10] = 0.0  # both zero: split_zeros fill
    for split in (True, False):
        ref = j_filters.softmask(jnp.asarray(x), jnp.asarray(ref_x), power=2.0, split_zeros=split)
        got = t_filters.softmask(torch.from_numpy(x), torch.from_numpy(ref_x), power=2.0, split_zeros=split)
        _close(got, ref)


@pytest.mark.parametrize("kernel_size", [31, 17])
def test_hpss_matches(kernel_size) -> None:
    """31 goes through median31 (its plain twin on the CPU), 17 through
    median_filter_1d; the JAX CPU path runs median_filter_1d for both."""

    mag = _mag(2 * SR)
    ref_h, ref_p = j_filters.hpss(jnp.asarray(mag), kernel_size=kernel_size, power=2.0)
    got_h, got_p = t_filters.hpss(torch.from_numpy(mag), kernel_size=kernel_size, power=2.0)
    _close(got_h, ref_h, atol=1e-6 * float(mag.max()))
    _close(got_p, ref_p, atol=1e-6 * float(mag.max()))


# ---------------------------------------------------------------------------
# Spectral features
# ---------------------------------------------------------------------------


def test_spectral_centroid_and_rolloff_match() -> None:
    mag = _mag()
    mag[:, 3] = 0.0  # silent frame: centroid 0 and rolloff at the first bin
    freqs = t_stft.fft_frequencies(SR, 2048)
    ref_c = j_spectral.spectral_centroid(jnp.asarray(mag), freqs)
    got_c = t_spectral.spectral_centroid(torch.from_numpy(mag), freqs)
    # a 1025-term weighted mean in Hz: summation order
    _close(got_c, ref_c, rtol=1e-5, atol=1e-3)
    ref_r = j_spectral.spectral_rolloff(jnp.asarray(mag), freqs, 0.85)
    got_r = t_spectral.spectral_rolloff(torch.from_numpy(mag), freqs, 0.85)
    _close(got_r, ref_r, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# Resampling / true peak
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("decim", [1, 8, 16])
def test_decimate_fir_matches(decim) -> None:
    sr = 44_100 if decim == 16 else SR
    y = _signal(70_001)
    ref = j_resample.decimate_fir(jnp.asarray(y), decim, sr=sr, keep_hz=1050.0)
    got = t_resample.decimate_fir(torch.from_numpy(y), decim, sr=sr, keep_hz=1050.0)
    assert got.shape == ref.shape
    _close(got, ref, rtol=1e-5, atol=2e-6)


def test_oversampled_peak_matches() -> None:
    y = _signal(40_000)
    ref = float(j_resample.oversampled_peak(jnp.asarray(y), 8))
    got = float(t_resample.oversampled_peak(torch.from_numpy(y), 8))
    assert got == pytest.approx(ref, rel=1e-6)


def test_resample_poly_host_matches() -> None:
    y = _signal(10_000)
    np.testing.assert_array_equal(
        t_resample.resample_poly_host(y, SR, 44_100), j_resample.resample_poly_host(y, SR, 44_100)
    )


# ---------------------------------------------------------------------------
# Chroma
# ---------------------------------------------------------------------------


def test_chroma_from_power_and_normalize_inf_match() -> None:
    power = _mag() ** 2
    power[:, 5] = 0.0  # silent frame: the inf-norm guard
    fb = t_chroma.chroma_stft_filterbank(SR, 2048)
    ref = j_chroma.chroma_from_power(jnp.asarray(power), fb)
    got = t_chroma.chroma_from_power(torch.from_numpy(power), fb)
    _close(got, ref, rtol=1e-5, atol=1e-6)


def test_cq_chroma_tribank_matches() -> None:
    y = _signal(4 * SR)
    mag = np.array(j_stft.magnitude(jnp.asarray(y), 2048, 512))
    kwargs = dict(sr=SR, hop=2048, family_n_fft=2048, family_hop=512)
    ref = j_chroma.cq_chroma_tribank(jnp.asarray(y), jnp.asarray(mag), **kwargs)
    got = t_chroma.cq_chroma_tribank(torch.from_numpy(y), torch.from_numpy(mag), **kwargs)
    assert got.shape == ref.shape
    # two float32 FFT spectrograms of the decimated signal feed it
    _close(got, ref, rtol=1e-5, atol=5e-6)


# ---------------------------------------------------------------------------
# Loudness
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [50_000, 4 * 32_768, 200_003])
def test_k_weighted_matches_on_both_branches(n) -> None:
    """n <= 4*32768: one transform; above: overlap-save."""

    y = _signal(n)
    ref = j_loud.k_weighted(jnp.asarray(y), SR)
    got = t_loud.k_weighted(torch.from_numpy(y), SR)
    assert got.shape == ref.shape
    # float32 FFT convolution with a 16384-tap filter
    _close(got, ref, rtol=0, atol=2e-5)


@pytest.mark.parametrize(
    "frame,hop,center", [(17_640, 4_410, False), (66_150, 33_075, True), (1_000, 300, True)]
)
def test_framed_energy_matches(frame, hop, center) -> None:
    """Chunk partials when frame % hop == 0, the framed tensor otherwise."""

    y = _signal(150_000)
    ref = j_loud.framed_energy(jnp.asarray(y), frame, hop, center=center)
    got = t_loud.framed_energy(torch.from_numpy(y), frame, hop, center=center)
    # float32 sums over thousands of squares
    _close(got, ref, rtol=2e-5, atol=1e-5)


@pytest.mark.parametrize("n_valid", [None, 120_000])
def test_integrated_lufs_matches(n_valid) -> None:
    y = _signal(150_000)
    y[120_000:] = 0.0
    ref = float(j_loud.integrated_lufs(jnp.asarray(y), SR, n_valid=n_valid))
    got = float(t_loud.integrated_lufs(torch.from_numpy(y), SR, n_valid=n_valid))
    assert got == pytest.approx(ref, abs=1e-4)


def test_rms_db_curve_matches() -> None:
    y = _signal(150_000)
    ref = j_loud.rms_db_curve(jnp.asarray(y), 13_230, 6_615)
    got = t_loud.rms_db_curve(torch.from_numpy(y), 13_230, 6_615)
    _close(got, ref, rtol=1e-5, atol=1e-4)
