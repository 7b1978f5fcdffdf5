"""The port's ``ops/stft.istft`` against the JAX package's, on the CPU.

Seeded numpy signals with |y| <= 1 go through ``stft`` then ``istft`` in
both packages (the JAX CPU path takes ``jnp.fft``): the round trip gives
the signal back, the port matches JAX with and without ``f_valid``, a
bucket-padded spectrogram inverts to the exact-shape samples, and a
batch equals its rows. Tolerance: 2e-6 absolute.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from track_analyser_tpu.ops.stft import istft as jax_istft
from track_analyser_tpu.ops.stft import stft as jax_stft
from track_analyser_tpu_torch.ops.stft import _overlap_add, istft, stft

torch.set_num_threads(2)

ATOL = 2e-6
FRAMINGS = [(2048, 512), (4096, 1024)]


def _signal(n: int, seed: int = 0, channels: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    shape = (channels, n) if channels else (n,)
    t = np.arange(n) / 44_100.0
    y = 0.4 * np.sin(2 * np.pi * 220.0 * t) + 0.3 * rng.uniform(-1.0, 1.0, shape)
    return np.clip(y, -1.0, 1.0).astype(np.float32)


@pytest.mark.parametrize("n_fft, hop", FRAMINGS)
def test_round_trip_gives_the_signal_back(n_fft, hop) -> None:
    y = _signal(40_000, seed=1)
    spec = stft(torch.from_numpy(y), n_fft, hop)
    back = istft(spec, n_fft, hop, y.shape[-1]).numpy()
    np.testing.assert_allclose(back, y, atol=ATOL)


@pytest.mark.parametrize("n_fft, hop", FRAMINGS)
def test_istft_matches_jax(n_fft, hop) -> None:
    y = _signal(33_000, seed=2)
    rng = np.random.default_rng(3)
    # a masked spectrogram, as the separators invert: not a consistent STFT
    ref_spec = np.asarray(jax_stft(jnp.asarray(y), n_fft, hop))
    mask = rng.uniform(0.0, 1.0, ref_spec.shape).astype(np.float32)
    ref = np.asarray(jax_istft(jnp.asarray(ref_spec * mask), n_fft, hop, y.shape[-1]))
    got = istft(torch.from_numpy(ref_spec * mask), n_fft, hop, y.shape[-1]).numpy()
    assert got.shape == ref.shape == y.shape
    np.testing.assert_allclose(got, ref, atol=ATOL)


@pytest.mark.parametrize("n_fft, hop", FRAMINGS)
def test_f_valid_matches_jax_and_the_exact_shape(n_fft, hop) -> None:
    """A padded signal with ``f_valid`` inverts to the samples of the
    exact-shape run on the first n samples, in both packages."""

    n, n_padded = 30_000, 65_536
    y = _signal(n, seed=4)
    padded = np.zeros(n_padded, dtype=np.float32)
    padded[:n] = y
    f_valid = 1 + n // hop
    spec = stft(torch.from_numpy(padded), n_fft, hop)
    got = istft(spec, n_fft, hop, n_padded, f_valid=f_valid).numpy()
    ref = np.asarray(
        jax_istft(
            jax_stft(jnp.asarray(padded), n_fft, hop), n_fft, hop, n_padded,
            f_valid=jnp.asarray(np.int32(f_valid)),
        )
    )
    # Compared on the n valid samples, which is what f_valid promises: past
    # them only the last valid frame's window tail is left in the
    # normaliser (down to 1e-8), and it magnifies float rounding.
    np.testing.assert_allclose(got[:n], ref[:n], atol=ATOL)
    assert np.all(np.isfinite(got)) and got.shape == ref.shape
    exact = istft(stft(torch.from_numpy(y), n_fft, hop), n_fft, hop, n).numpy()
    np.testing.assert_allclose(got[:n], exact, atol=ATOL)
    np.testing.assert_allclose(got[:n], y, atol=ATOL)
    # a tensor f_valid is the same as an int
    as_tensor = istft(spec, n_fft, hop, n_padded, f_valid=torch.tensor(f_valid)).numpy()
    np.testing.assert_array_equal(as_tensor, got)


def test_imaginary_dc_and_nyquist_are_ignored_and_the_input_is_kept() -> None:
    """A complex mask leaves imaginary parts on the DC and Nyquist bins,
    which no real signal has. ``istft`` drops them on every device (the
    host's transform ignores them; cuFFT's does not always) and does not
    write to its input."""

    rng = np.random.default_rng(8)
    y = _signal(30_000, seed=8)
    spec = stft(torch.from_numpy(y), 2048, 512)
    mask = torch.from_numpy((rng.normal(size=spec.shape) + 1j * rng.normal(size=spec.shape)).astype(np.complex64))
    masked = spec * mask
    assert float(masked[0].imag.abs().max()) > 1.0 and float(masked[-1].imag.abs().max()) > 1e-3
    kept = masked.clone()
    got = istft(masked, 2048, 512, y.shape[-1])
    assert torch.equal(masked, kept)
    real_edges = masked.clone()
    real_edges.imag[0] = 0.0
    real_edges.imag[-1] = 0.0
    assert torch.equal(got, istft(real_edges, 2048, 512, y.shape[-1]))
    ref = np.asarray(jax_istft(jnp.asarray(masked.numpy()), 2048, 512, y.shape[-1]))
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL * float(np.abs(ref).max()))


def test_batched_equals_per_row() -> None:
    y = _signal(20_000, seed=5, channels=3)
    spec = stft(torch.from_numpy(y), 2048, 512)
    both = istft(spec, 2048, 512, y.shape[-1], f_valid=30)
    assert both.shape == (3, y.shape[-1])
    for c in range(3):
        row = istft(spec[c], 2048, 512, y.shape[-1], f_valid=30)
        assert torch.equal(both[c], row)
    # leading axes beyond one: (2, 3, bins, frames)
    stacked = istft(torch.stack([spec, 0.5 * spec]), 2048, 512, y.shape[-1])
    assert stacked.shape == (2, 3, y.shape[-1])
    np.testing.assert_allclose(stacked[1].numpy(), 0.5 * stacked[0].numpy(), atol=ATOL)


def test_overlap_add_slabs_equal_the_scatter() -> None:
    """The shifted-slab overlap-add against ``index_add_`` (the general
    branch, taken when the hop does not divide the frame)."""

    rng = np.random.default_rng(6)
    frames = torch.from_numpy(rng.normal(size=(2, 11, 64)).astype(np.float32))
    slabs = _overlap_add(frames, 16)
    ref = torch.zeros(2, 11 * 16 + 64)
    for t in range(11):
        ref[:, t * 16 : t * 16 + 64] += frames[:, t]
    np.testing.assert_allclose(slabs.numpy(), ref.numpy(), atol=1e-6)
    odd = _overlap_add(frames, 24)  # 64 % 24 != 0
    ref = torch.zeros(2, 11 * 24 + 64)
    for t in range(11):
        ref[:, t * 24 : t * 24 + 64] += frames[:, t]
    np.testing.assert_allclose(odd.numpy(), ref.numpy(), atol=1e-6)
