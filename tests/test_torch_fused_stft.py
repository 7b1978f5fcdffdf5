"""The port's fused |STFT| (``ops/fused_stft``) against the JAX package.

On the CPU the wrapper runs its plain version (frames @ the windowed
DFT basis, twice, then the magnitude). It is held against the Pallas
kernel in interpret mode and against JAX ``ops/stft.magnitude`` (rfft)
on the reference test's shapes, at its tolerance: 2e-6 of each frame's
spectral norm (absolute error against a tiny bin of a loud frame is the
float32 summation floor, not a defect). The CUDA kernel itself runs only
on the card (the ``gpu`` test below, and ``chip_smoke.py`` phase 6).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from track_analyser_tpu.ops.pallas_stft import stft_magnitude as jax_fused
from track_analyser_tpu.ops.stft import magnitude as jax_magnitude
from track_analyser_tpu_torch.ops import fused_stft
from track_analyser_tpu_torch.ops.stft import magnitude

torch.set_num_threads(2)


def _frame_norm_err(out: np.ndarray, ref: np.ndarray) -> float:
    norm = np.linalg.norm(ref, axis=-2, keepdims=True)
    return float((np.abs(out - ref) / (norm + 1e-9)).max())


@pytest.mark.parametrize("n", [44_100, 44_100 * 3 + 1_234, 1 << 15])
def test_plain_version_matches_pallas_kernel_and_rfft(n) -> None:
    y = np.random.default_rng(7).normal(0.0, 0.3, (2, n)).astype(np.float32)
    before = fused_stft.stft_magnitude.launches
    got = fused_stft.stft_magnitude(torch.from_numpy(y), 2048, 512).numpy()
    assert fused_stft.stft_magnitude.launches == before  # the CPU path counts nothing
    kernel = np.asarray(jax_fused(jnp.asarray(y), 2048, 512, interpret=True))
    rfft = np.asarray(jax_magnitude(jnp.asarray(y), 2048, 512))
    assert got.shape == kernel.shape == rfft.shape == (2, 1025, 1 + n // 512)
    assert got.flags.c_contiguous
    assert _frame_norm_err(got, kernel) < 2e-6
    assert _frame_norm_err(got, rfft) < 2e-6


def test_mono_input_promotes_to_one_channel() -> None:
    y = np.random.default_rng(3).normal(0.0, 0.2, 44_100).astype(np.float32)
    got = fused_stft.stft_magnitude(torch.from_numpy(y), 2048, 512).numpy()
    ref = np.asarray(jax_magnitude(jnp.asarray(y), 2048, 512))
    assert got.shape == (1,) + ref.shape
    assert _frame_norm_err(got[0], ref) < 2e-6


def test_plain_version_matches_the_port_cufft_path() -> None:
    """The two branches of the graph's STFT switch agree (``ops/stft``
    is the torch.fft path the port takes without TA_PALLAS_STFT=1)."""

    y = torch.from_numpy(np.random.default_rng(5).normal(0.0, 0.3, (4, 30_000)).astype(np.float32))
    got = fused_stft.stft_magnitude(y, 2048, 512).numpy()
    ref = magnitude(y, 2048, 512).numpy()
    assert _frame_norm_err(got, ref) < 2e-6


def test_tone_peak_bin_and_padding_region() -> None:
    """A sine concentrates in its bin, and frames centred in a zero tail
    are near-silent (the bucket padding the graph relies on), as the
    reference's kernel test asks of it."""

    sr = 44_100
    t = np.arange(sr * 2) / sr
    y = np.concatenate([0.5 * np.sin(2 * np.pi * 440.0 * t), np.zeros(sr // 2)]).astype(np.float32)
    out = fused_stft.stft_magnitude(torch.from_numpy(y), 2048, 512).numpy()[0]
    bin_440 = int(round(440.0 * 2048 / sr))
    assert out[:, out.shape[1] // 3].argmax() in (bin_440, bin_440 + 1)
    assert out[:, -3:].max() < 1e-3 * out.max()


@pytest.mark.parametrize(
    "n_fft, hop",
    [(2048, 300), (1000, 512), (2048, 2048)],  # hop-misaligned n_fft; centre pad not a hop multiple
)
def test_wrapper_raises_on_hop_misaligned_frames(n_fft, hop) -> None:
    with pytest.raises(ValueError, match="hop"):
        fused_stft.stft_magnitude(torch.zeros(2, 10_000), n_fft, hop)


@pytest.mark.parametrize(
    "bad, error",
    [
        (torch.zeros(2, 10_000, dtype=torch.float64), TypeError),
        (torch.zeros(2, 2, 10_000), ValueError),
    ],
)
def test_wrapper_rejects_what_the_kernel_does_not_take(bad, error) -> None:
    with pytest.raises(error):
        fused_stft.stft_magnitude(bad, 2048, 512)


def test_windowed_basis_is_the_hann_dft() -> None:
    """Columns past the real bins are zero, and frames @ basis is the
    windowed rfft (the basis the kernel reads)."""

    wcos, wsin = fused_stft.windowed_basis(2048, "cpu")
    assert wcos.shape == wsin.shape and wcos.shape[0] == 2048 and wcos.shape[1] % 64 == 0
    assert torch.count_nonzero(wcos[:, 1025:]) == 0 and torch.count_nonzero(wsin[:, 1025:]) == 0
    frame = np.random.default_rng(1).normal(size=2048)
    win = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(2048) / 2048)
    ref = np.fft.rfft(frame * win)
    f = torch.from_numpy(frame.astype(np.float32))
    np.testing.assert_allclose((f @ wcos[:, :1025]).numpy(), ref.real, atol=2e-4)
    np.testing.assert_allclose((f @ wsin[:, :1025]).numpy(), -ref.imag, atol=2e-4)


@pytest.mark.gpu
def test_cuda_kernel_matches_plain_version() -> None:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the stft_mag kernel has no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for shape in [(2, 44_100 * 3 + 1_234), (1, 1 << 15), (3, 5_000), (44_100,)]:
        y = torch.randn(shape, device="cuda", generator=gen) * 0.3
        before = fused_stft.stft_magnitude.launches
        got = fused_stft.stft_magnitude(y, 2048, 512)
        torch.cuda.synchronize()
        assert fused_stft.stft_magnitude.launches == before + 1
        ref = fused_stft.stft_magnitude_reference(y, 2048, 512)
        assert _frame_norm_err(got.cpu().numpy(), ref.cpu().numpy()) < 2e-6, shape
