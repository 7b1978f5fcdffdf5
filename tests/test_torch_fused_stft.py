"""The port's fused |STFT| (``ops/fused_stft``) against the JAX package.

On the CPU the wrapper runs its plain version (frames @ the windowed
DFT basis, twice, then the magnitude). It is held against the Pallas
kernel in interpret mode and against JAX ``ops/stft.magnitude`` (rfft)
on the reference test's shapes, at its tolerance: 2e-6 of each frame's
spectral norm (absolute error against a tiny bin of a loud frame is the
float32 summation floor, not a defect). The CUDA kernel itself runs only
on the card (the ``gpu`` test below, and ``chip_smoke.py`` phase 6); its
algorithm (a 32 x 32 real FFT on float32 tables, untangled in pairs) runs
here as ``stft_magnitude_model``, held to the same references and
tolerance, and its tables are held against float64 numpy.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from track_analyser_tpu.ops.pallas_stft import stft_magnitude as jax_fused
from track_analyser_tpu.ops.stft import magnitude as jax_magnitude
from track_analyser_tpu_torch import profile_stft
from track_analyser_tpu_torch.ops import cuda_build, fused_stft
from track_analyser_tpu_torch.ops.stft import hann_window, magnitude

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


@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("n", [44_100, 44_100 * 3 + 1_234, 1 << 15])
def test_kernel_model_matches_plain_version_pallas_kernel_and_rfft(n, channels) -> None:
    """The CUDA kernel's steps, in plain PyTorch on the kernel's float32
    tables, against the plain version, the Pallas kernel in interpret mode
    and the JAX rfft path; mono goes in 1-D, as the wrapper takes it."""

    y = np.random.default_rng(11).normal(0.0, 0.3, (channels, n)).astype(np.float32)
    given = y[0] if channels == 1 else y
    model = fused_stft.stft_magnitude_model(torch.from_numpy(given), 2048, 512).numpy()
    plain = fused_stft.stft_magnitude_reference(torch.from_numpy(given), 2048, 512).numpy()
    kernel = np.asarray(jax_fused(jnp.asarray(y), 2048, 512, interpret=True))
    rfft = np.asarray(jax_magnitude(jnp.asarray(y), 2048, 512))
    assert model.shape == plain.shape == kernel.shape == rfft.shape == (channels, 1025, 1 + n // 512)
    assert model.flags.c_contiguous
    assert _frame_norm_err(model, plain) < 2e-6
    assert _frame_norm_err(model, kernel) < 2e-6
    assert _frame_norm_err(model, rfft) < 2e-6


def test_kernel_model_against_a_float64_fft() -> None:
    """An FFT rounds less than a 2 048-term sum: the model sits closer to
    a float64 transform than the plain version does."""

    y = np.random.default_rng(2).normal(0.0, 0.3, (2, 40_000)).astype(np.float32)
    framed = fused_stft.frame_signal(torch.from_numpy(y).double(), 2048, 512).numpy()
    window = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(2048) / 2048)
    exact = np.abs(np.fft.rfft(framed * window, axis=-1)).transpose(0, 2, 1)
    model = fused_stft.stft_magnitude_model(torch.from_numpy(y), 2048, 512).numpy()
    plain = fused_stft.stft_magnitude_reference(torch.from_numpy(y), 2048, 512).numpy()
    assert _frame_norm_err(model, exact) < 1e-7
    assert _frame_norm_err(model, exact) < _frame_norm_err(plain, exact)


def test_kernel_model_on_a_signal_shorter_than_a_frame() -> None:
    y = np.random.default_rng(4).normal(0.0, 0.3, (3, 1_000)).astype(np.float32)
    model = fused_stft.stft_magnitude_model(torch.from_numpy(y), 2048, 512).numpy()
    plain = fused_stft.stft_magnitude_reference(torch.from_numpy(y), 2048, 512).numpy()
    assert model.shape == (3, 1025, 2)
    assert _frame_norm_err(model, plain) < 2e-6


def test_kernel_model_on_an_impulse_and_a_tone() -> None:
    """An impulse is flat over the bins at the window's value; a tone on a
    bin centre reads amplitude * 512 there and half of it beside it (the
    paired untangle of bins k and 1024 - k, bins 0, 512 and 1024 included,
    has nowhere to hide)."""

    impulse = torch.zeros(1, 20_000)
    impulse[0, 5_000] = 1.0
    out = fused_stft.stft_magnitude_model(impulse, 2048, 512).numpy()[0]
    flat = 0.5 - 0.5 * np.cos(2.0 * np.pi * 904 / 2048)  # frame 10 starts at sample 4096
    np.testing.assert_allclose(out[:, 10], flat, rtol=0, atol=2e-6 * flat * np.sqrt(1025))
    assert out[:, 0].max() == 0.0  # frame 0 ends before the impulse
    for k in (0, 100, 512, 924, 1024):
        amplitude = 0.5 if k in (0, 1024) else 1.0  # cos on bin 0 or 1024 is its own mirror image
        tone = (0.5 * amplitude * np.cos(2.0 * np.pi * k / 2048 * np.arange(16_384))).astype(np.float32)
        inner = fused_stft.stft_magnitude_model(torch.from_numpy(tone), 2048, 512).numpy()[0][:, 4:-4]
        assert (inner.argmax(axis=0) == k).all()
        np.testing.assert_allclose(inner[k], 256.0, rtol=0, atol=1e-3)
        for side in (k - 1, k + 1):
            if 0 <= side <= 1024:
                np.testing.assert_allclose(inner[side], 128.0, rtol=0, atol=1e-3)


def test_fft32_registers_is_a_bit_reversed_dft() -> None:
    """The kernel's 32-point pass: X[k] lands in register brev5(k)."""

    rng = np.random.default_rng(9)
    z = rng.normal(size=(32, 5)) + 1j * rng.normal(size=(32, 5))  # [register][lane]
    re = [torch.from_numpy(z[r].real.astype(np.float32)) for r in range(32)]
    im = [torch.from_numpy(z[r].imag.astype(np.float32)) for r in range(32)]
    fused_stft._fft32_registers(re, im)
    want = np.fft.fft(z, axis=0)
    for k in range(32):
        got = re[fused_stft._brev5(k)].numpy() + 1j * im[fused_stft._brev5(k)].numpy()
        np.testing.assert_allclose(got, want[k], atol=2e-5)
    assert sorted(fused_stft._brev5(k) for k in range(32)) == list(range(32))


def test_fft_tables_are_float64_values_rounded_once() -> None:
    tables = fused_stft.fft_tables(2048, "cpu")
    assert tables.dtype == torch.float32 and tables.shape == (5120,) and tables.is_contiguous()
    t = tables.numpy()
    j = np.arange(2048, dtype=np.float64)
    np.testing.assert_array_equal(t[:2048], (0.25 - 0.25 * np.cos(2.0 * np.pi * j / 2048)).astype(np.float32))
    np.testing.assert_array_equal(2.0 * t[:2048], hann_window(2048))  # halving is exact
    k1, n2 = np.meshgrid(np.arange(32), np.arange(32), indexing="ij")
    inner = np.exp(-2j * np.pi * (k1 * n2) / 1024).reshape(-1)
    np.testing.assert_allclose(t[2048:3072], inner.real, rtol=0, atol=6e-8)
    np.testing.assert_allclose(t[3072:4096], inner.imag, rtol=0, atol=6e-8)
    untangle = np.exp(-2j * np.pi * np.arange(512) / 2048)
    np.testing.assert_allclose(t[4096:4608], untangle.real, rtol=0, atol=6e-8)
    np.testing.assert_allclose(t[4608:], untangle.imag, rtol=0, atol=6e-8)
    # exact where the value is exact: W^0, W^256 = -i, W^512 = -1
    assert t[2048] == 1.0 and t[3072] == 0.0 and t[4096] == 1.0 and t[4608] == 0.0
    assert t[3072 + 32 * 16 + 16] == -1.0 and abs(t[2048 + 32 * 16 + 16]) < 1e-7  # k1 n2 = 256
    with pytest.raises(ValueError, match="2048"):
        fused_stft.fft_tables(1024, "cpu")


@pytest.mark.parametrize("name", sorted(profile_stft.EDITS))
def test_profile_edits_still_apply_to_the_kernel_source(name) -> None:
    """``profile_stft`` takes the kernel apart by text replacement: each
    piece it replaces must be in ``csrc/stft_mag.cu`` exactly once."""

    text = (cuda_build.CSRC / "stft_mag.cu").read_text()
    for old, new in profile_stft.EDITS[name]:
        assert text.count(old) == 1, old
        assert new not in text


def test_profile_cycle_counters_still_apply_to_the_kernel_source() -> None:
    """The copy that counts cycles: every tick finds its place once, alone
    and together with the edit that removes the stores."""

    for edits in (profile_stft.PHASE_EDITS, profile_stft.PHASE_EDITS + profile_stft.EDITS["no stores"]):
        text = profile_stft.edited(edits)
        assert text.count("clock64()") == 1 + 6 and "stft_mag_read_spent" in text
    with pytest.raises(RuntimeError, match="exactly once"):
        profile_stft.edited([("no such line in the kernel", "")])


def test_build_text_compiles_once_per_text(tmp_path, monkeypatch) -> None:
    """A library is named by its source text's hash: the same text builds
    once, another text builds beside it (nvcc itself runs only on the card)."""

    compiled = []

    def fake_compile(src, lib_path):
        compiled.append(src.read_text())
        lib_path.write_bytes(b"")
        return "log"

    monkeypatch.setattr(cuda_build, "_BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(cuda_build, "_compile", fake_compile)
    first, log = cuda_build.build_text("probe", "// a")
    again, cached = cuda_build.build_text("probe", "// a")
    other, _ = cuda_build.build_text("probe", "// b")
    assert (log, cached) == ("log", "") and first == again != other
    assert compiled == ["// a", "// b"]
    assert first.parent == tmp_path / "kernels" and first.name.startswith("libprobe_")


def test_launch_signature_matches_the_c_entry() -> None:
    """``stft_mag_launch``'s parameters in the source, in order, against
    the ctypes signature the wrapper binds (a mismatch would cut a pointer)."""

    import ctypes
    import re

    text = (cuda_build.CSRC / "stft_mag.cu").read_text()
    params = re.search(r'extern "C" int stft_mag_launch\((.*?)\)', text, re.S).group(1).split(",")
    kinds = {"*": ctypes.c_void_p, "long long": ctypes.c_longlong, "int": ctypes.c_int}
    want = [next(v for k, v in kinds.items() if k in p) for p in params]
    assert want == fused_stft.LAUNCH_ARGTYPES


@pytest.mark.gpu
def test_cuda_kernel_matches_plain_version() -> None:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the stft_mag kernel has no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(0)
    ragged = 44_100 * 3 + 1_234
    inputs = [
        torch.randn(shape, device="cuda", generator=gen) * 0.3
        for shape in [(2, ragged), (1, 1 << 15), (3, 5_000), (44_100,), (1_000,), (8, ragged)]
    ]
    inputs.append((torch.randn((3, 2 * ragged), device="cuda", generator=gen) * 0.3)[:, ::2])  # strided
    impulse = torch.zeros((1, 20_000), device="cuda")
    impulse[0, 5_000] = 1.0
    tone = (0.5 * torch.cos(2.0 * np.pi * 100.0 / 2048 * torch.arange(65_536, device="cuda", dtype=torch.float64))).float()
    inputs += [impulse, tone]
    for y in inputs:
        before = fused_stft.stft_magnitude.launches
        got = fused_stft.stft_magnitude(y, 2048, 512)
        torch.cuda.synchronize()
        assert fused_stft.stft_magnitude.launches == before + 1
        assert got.is_contiguous()
        ref = fused_stft.stft_magnitude_reference(y, 2048, 512)
        assert got.shape == ref.shape
        assert _frame_norm_err(got.cpu().numpy(), ref.cpu().numpy()) < 2e-6, tuple(y.shape)
    inner = got[0, :, 4:-4]  # the tone: 256 on bin 100, 128 beside it
    assert bool((inner.argmax(dim=0) == 100).all())
    assert float((inner[100] - 256.0).abs().max()) < 1e-3 and float((inner[99] - 128.0).abs().max()) < 1e-3
    with pytest.raises(ValueError, match="2048"):
        fused_stft.stft_magnitude(inputs[0], 1024, 256)  # no other (n_fft, hop) on the card, and no fallback
