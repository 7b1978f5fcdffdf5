"""The port's band-split mask net against the JAX package's, on the CPU.

The bundled checkpoints (v5: width 144, four dilated blocks; v4: width
96, two blocks) and a random-weight net of width 16 go through
``params_from_jax``; ``forward_masks`` and the separators are compared
with the JAX functions on seeded numpy signals of peak <= 1. Tolerance:
1e-4 absolute on the masks' real and imaginary parts and on the stems.
"""

from __future__ import annotations

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from track_analyser_tpu.models import separation_net as jnet
from track_analyser_tpu.ops.stft import stft as jax_stft
from track_analyser_tpu_torch.models import separation, separation_net as tnet
from track_analyser_tpu_torch.ops.stft import stft

torch.set_num_threads(2)

ATOL = 1e-4
SR = 44_100
CKPT_DIR = Path(jnet.__file__).parent / "checkpoints"
# version -> (width, blocks, dilations)
BUNDLED = {5: (144, 4, (1, 3, 9, 27)), 4: (96, 2, (1, 1))}


def _mixture(n: int, seed: int, channels: int = 0) -> np.ndarray:
    """Kick grid + a tone + noise hats, peak 0.9."""

    rng = np.random.default_rng(seed)
    t = np.arange(n) / SR
    rows = []
    for c in range(max(channels, 1)):
        y = 0.3 * np.sin(2 * np.pi * (110.0 + 30.0 * c) * t) + 0.2 * np.sin(2 * np.pi * 440.0 * t)
        for b in np.arange(0.0, n / SR, 0.5):
            s = int(b * SR)
            e = min(n, s + 2_000)
            seg = np.arange(e - s) / SR
            y[s:e] += 0.6 * np.sin(2 * np.pi * 70.0 * seg) * np.exp(-seg * 40)
        y += 0.05 * rng.normal(size=n)
        rows.append(y)
    x = np.stack(rows) if channels else rows[0]
    return (x * (0.9 / np.abs(x).max())).astype(np.float32)


def _jax_params(version: int) -> tuple[dict, "tuple | None"]:
    params = jnet.load_checkpoint(CKPT_DIR / f"separation_v{version}.npz")
    dilations = jnet.checkpoint_dilations(params)
    params.pop("_dilations", None)
    return params, dilations


def _random_params(seed: int = 0, d_model: int = 16, n_blocks: int = 2) -> dict:
    """Random weights in the checkpoint layout, biases included, made
    with numpy."""

    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(
        lambda: jnet.init_params(jax.random.PRNGKey(0), d_model=d_model, n_blocks=n_blocks)
    )
    return {
        k: (rng.normal(size=v.shape) * (0.3 if k.endswith("_w") else 0.1)).astype(np.float32)
        for k, v in shapes.items()
    }


def test_band_edges_match_jax() -> None:
    assert tnet.band_edges(16) == jnet.band_edges(16)
    assert len(tnet.band_edges(16)) == 15
    assert tnet.STEMS == jnet.STEMS


@pytest.mark.parametrize("version", sorted(BUNDLED))
def test_params_from_jax_reads_depth_width_dilations(version) -> None:
    width, blocks, dilations = BUNDLED[version]
    params = tnet.load_checkpoint(CKPT_DIR / f"separation_v{version}.npz")
    model = tnet.params_from_jax(params)
    assert model.dilations == dilations
    assert len(model.dilations) == blocks
    assert model.p["blk0_tmix_w"].shape == (width, width)
    assert model.p["blk0_bmix_w"].shape == (15, 15)
    assert not model.training
    n_weights = sum(int(np.asarray(v).size) for k, v in params.items() if k != "_dilations")
    assert sum(p.numel() for p in model.parameters()) == n_weights
    for name, value in params.items():
        if name != "_dilations":
            np.testing.assert_array_equal(model.p[name].detach().numpy(), value)
    assert tnet.checkpoint_dilations(params) == (dilations if version == 5 else None)


def test_params_from_jax_refuses_a_mismatched_checkpoint() -> None:
    params = _random_params()
    del params["enc3_b"]
    with pytest.raises(ValueError, match="disagree"):
        tnet.params_from_jax(params)


@pytest.mark.parametrize("version", sorted(BUNDLED))
def test_forward_masks_match_jax(version) -> None:
    params, dilations = _jax_params(version)
    model = tnet.params_from_jax(tnet.load_checkpoint(CKPT_DIR / f"separation_v{version}.npz"))
    y = _mixture(3 * SR, seed=version)
    ref = jnet.forward_masks(params, jax_stft(jnp.asarray(y), 2048, 512), dilations=dilations)
    with torch.inference_mode():
        got = tnet.forward_masks(model, stft(torch.from_numpy(y), 2048, 512))
    assert tuple(got) == jnet.STEMS
    for stem in jnet.STEMS:
        want = np.asarray(ref[stem])
        assert tuple(got[stem].shape) == want.shape == (1025, 1 + y.size // 512)
        np.testing.assert_allclose(got[stem].real.numpy(), want.real, atol=ATOL, err_msg=stem)
        np.testing.assert_allclose(got[stem].imag.numpy(), want.imag, atol=ATOL, err_msg=stem)


def test_random_net_masks_match_jax_with_dilations_and_f_valid() -> None:
    """Width 16, two blocks, dilations (1, 3), every bias non-zero, on a
    padded spectrogram with ``f_valid``."""

    params = _random_params(seed=3)
    dilations = (1, 3)
    model = tnet.params_from_jax({**params, "_dilations": np.asarray(dilations)})
    assert model.dilations == dilations and model.p["blk0_tconv"].shape == (5, 16)
    n, n_padded = 20_000, 32_768
    padded = np.zeros(n_padded, dtype=np.float32)
    padded[:n] = _mixture(n, seed=9)
    f_valid = 1 + n // 512
    ref = jnet.forward_masks(
        {k: jnp.asarray(v) for k, v in params.items()},
        jax_stft(jnp.asarray(padded), 2048, 512),
        f_valid=jnp.asarray(np.int32(f_valid)),
        dilations=dilations,
    )
    with torch.inference_mode():
        got = tnet.forward_masks(model, stft(torch.from_numpy(padded), 2048, 512), f_valid=f_valid)
    for stem in jnet.STEMS:
        want = np.asarray(ref[stem])
        np.testing.assert_allclose(got[stem].real.numpy(), want.real, atol=ATOL, err_msg=stem)
        np.testing.assert_allclose(got[stem].imag.numpy(), want.imag, atol=ATOL, err_msg=stem)


def test_padded_masks_equal_exact_shape_on_valid_frames() -> None:
    model = tnet.params_from_jax(tnet.load_checkpoint(CKPT_DIR / "separation_v5.npz"))
    n, n_padded = 40_000, 65_536
    y = _mixture(n, seed=11)
    padded = np.zeros(n_padded, dtype=np.float32)
    padded[:n] = y
    f_valid = 1 + n // 512
    with torch.inference_mode():
        exact = tnet.forward_masks(model, stft(torch.from_numpy(y), 2048, 512))
        wide = tnet.forward_masks(model, stft(torch.from_numpy(padded), 2048, 512), f_valid=f_valid)
    # The last two frames see the zero padding of the STFT itself in one
    # run and zeros of the bucket in the other: the same samples.
    for stem in jnet.STEMS:
        np.testing.assert_allclose(
            torch.view_as_real(wide[stem][:, :f_valid]).numpy(),
            torch.view_as_real(exact[stem]).numpy(),
            atol=ATOL,
            err_msg=stem,
        )


def test_separate_signal_multi_equals_per_channel_and_matches_jax() -> None:
    params, dilations = _jax_params(5)
    model = tnet.params_from_jax(tnet.load_checkpoint(CKPT_DIR / "separation_v5.npz"))
    n = 32_768
    y = _mixture(n, seed=12, channels=2)
    f_valid = 1 + 30_000 // 512
    multi = tnet.separate_signal_multi(model, torch.from_numpy(y), n_samples=n, f_valid=f_valid)
    assert multi.shape == (2, 4, n)
    for c in range(2):
        one = tnet.separate_signal(model, torch.from_numpy(y[c]), n_samples=n, f_valid=f_valid)
        assert one.shape == (4, n)
        np.testing.assert_allclose(multi[c].numpy(), one.numpy(), atol=2e-6)
    ref = np.asarray(
        jnet.separate_signal_multi(
            params, jnp.asarray(y), n_samples=n, f_valid=jnp.asarray(np.int32(f_valid)),
            dilations=dilations,
        )
    )
    np.testing.assert_allclose(multi.numpy()[..., :30_000], ref[..., :30_000], atol=ATOL)
    with pytest.raises(ValueError):
        tnet.separate_signal(model, torch.from_numpy(y), n_samples=n)
    with pytest.raises(ValueError):
        tnet.separate_signal_multi(model, torch.from_numpy(y[0]), n_samples=n)


@pytest.mark.parametrize("channels", [0, 2], ids=["mono", "stereo"])
@pytest.mark.parametrize("version", sorted(BUNDLED))
def test_run_from_checkpoint_matches_jax(version, channels) -> None:
    path = CKPT_DIR / f"separation_v{version}.npz"
    y = _mixture(2 * SR + 123, seed=20 + version, channels=channels)
    ref = jnet.run_from_checkpoint(path, y, SR)
    got = tnet.run_from_checkpoint(path, y, SR, device="cpu")
    assert tuple(got) == tuple(ref) == jnet.STEMS
    for stem in jnet.STEMS:
        assert got[stem].shape == ref[stem].shape == y.shape
        assert got[stem].dtype == np.float32
        np.testing.assert_allclose(got[stem], ref[stem], atol=ATOL, err_msg=stem)


def test_resolver_order_name_and_env_override(monkeypatch, tmp_path) -> None:
    monkeypatch.delenv("TRACK_ANALYSER_TPU_SEPARATION_CKPT", raising=False)
    assert separation.available()
    assert separation._checkpoint_path().name == "separation_v5.npz"
    assert [p.name for p in separation._BUNDLED] == [f"separation_v{v}.npz" for v in (5, 4, 3, 2, 1)]
    assert separation.model_name() == separation.MODEL_NAME == "bandsplit-masknet-v5"
    monkeypatch.setenv("TRACK_ANALYSER_TPU_SEPARATION_CKPT", str(CKPT_DIR / "separation_v4.npz"))
    assert separation.model_name() == "bandsplit-masknet-v4"
    y = _mixture(SR, seed=30)
    got = separation.separate(y, SR, device="cpu")
    ref = jnet.run_from_checkpoint(CKPT_DIR / "separation_v4.npz", y, SR)
    for stem in jnet.STEMS:
        np.testing.assert_allclose(got[stem], ref[stem], atol=ATOL, err_msg=stem)
    monkeypatch.setenv("TRACK_ANALYSER_TPU_SEPARATION_CKPT", str(tmp_path / "missing.npz"))
    assert separation.model_name() == "bandsplit-masknet-v5"  # a missing override is ignored
    monkeypatch.setattr(separation, "_BUNDLED", ())
    assert not separation.available() and separation.separate(y, SR, device="cpu") is None


def test_run_from_checkpoint_cuda_raises_without_cuda() -> None:
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here; the error path needs a host without it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tnet.run_from_checkpoint(CKPT_DIR / "separation_v5.npz", _mixture(SR, seed=1), SR)
