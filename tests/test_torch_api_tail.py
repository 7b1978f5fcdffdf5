"""The port's last public functions and its ``python -m`` entry points,
against the JAX package on the CPU.

Tolerances, stated per check: ``ltas`` within 1e-6 relative;
``ebu_loudness_range`` within 1e-3 LU; the CQ chroma filterbanks within
1e-6 (absolute, on banks of unit scale) and ``cq_chroma_multires`` within
1e-5 of each frame's largest value; ``get_version`` equal. The training
entry points run two steps on the CPU and write checkpoints that the JAX
loaders read with the JAX key names and shapes; without CUDA and without
``--device`` they raise, as every entry point of the port does.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import track_analyser_tpu
import track_analyser_tpu.models.downbeat_net as j_db
import track_analyser_tpu.models.separation_net as j_sep
import track_analyser_tpu.ops.chroma as j_chroma
import track_analyser_tpu.ops.loudness as j_loud
import track_analyser_tpu.ops.spectral as j_spec
import track_analyser_tpu_torch
from track_analyser_tpu_torch.models import downbeat_net as t_db
from track_analyser_tpu_torch.models import training as t_tr
from track_analyser_tpu_torch.native import build as t_build
from track_analyser_tpu_torch.ops import chroma as t_chroma
from track_analyser_tpu_torch.ops import loudness as t_loud
from track_analyser_tpu_torch.ops import spectral as t_spec

torch.set_num_threads(2)


def _programme(seconds: float, sr: int, seed: int) -> np.ndarray:
    """Tones and noise bursts at three levels, with a quiet stretch in the
    middle: a gated loudness distribution with a real spread."""

    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    level = np.where(t < seconds * 0.4, 0.3, np.where(t < seconds * 0.6, 0.01, 0.12))
    y = level * (np.sin(2 * np.pi * 220.0 * t) + 0.5 * np.sin(2 * np.pi * 1_760.0 * t))
    y += level * rng.normal(0.0, 0.2, t.size) * (np.sin(2 * np.pi * 2.0 * t) > 0.5)
    return y.astype(np.float32)


def test_ltas_matches_jax() -> None:
    mag = np.abs(np.random.default_rng(1).normal(size=(2, 513, 97))).astype(np.float32)
    want = np.asarray(j_spec.ltas(jnp.asarray(mag)))
    got = t_spec.ltas(torch.from_numpy(mag)).numpy()
    assert got.shape == want.shape == (2, 513)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("sr", [22_050, 44_100])
def test_ebu_loudness_range_matches_jax(sr) -> None:
    y = _programme(20.0, sr, seed=sr)
    want = float(j_loud.ebu_loudness_range(jnp.asarray(y), sr))
    got = t_loud.ebu_loudness_range(torch.from_numpy(y), sr)
    assert got.dim() == 0 and got.dtype == torch.float32
    assert want > 5.0  # the quiet stretch spreads the distribution
    assert abs(float(got) - want) <= 1e-3, (float(got), want)


def test_ebu_loudness_range_short_signal_is_zero() -> None:
    y = _programme(2.0, 22_050, seed=2)
    assert float(j_loud.ebu_loudness_range(jnp.asarray(y), 22_050)) == 0.0
    assert float(t_loud.ebu_loudness_range(torch.from_numpy(y), 22_050)) == 0.0


@pytest.mark.parametrize("sr,n_fft", [(22_050, 4_096), (44_100, 8_192)])
def test_cq_chroma_filterbank_matches_jax(sr, n_fft) -> None:
    want = j_chroma.cq_chroma_filterbank(sr, n_fft)
    got = t_chroma.cq_chroma_filterbank(sr, n_fft)
    assert got.shape == want.shape == (12, 1 + n_fft // 2) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_multires_cq_filterbanks_match_jax() -> None:
    want = j_chroma.multires_cq_filterbanks(44_100, 8_192, 4_096, 16)
    got = t_chroma.multires_cq_filterbanks(44_100, 8_192, 4_096, 16)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == np.float32
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)


@pytest.mark.parametrize("sr", [22_050, 44_100])
def test_cq_chroma_multires_matches_jax(sr) -> None:
    rng = np.random.default_rng(3)
    t = np.arange(4 * sr) / sr
    # an A minor triad over a bass A, with a little noise
    y = sum(a * np.sin(2 * np.pi * f * t) for a, f in ((0.3, 110.0), (0.2, 440.0), (0.2, 523.25), (0.2, 659.26)))
    y = (y + rng.normal(0.0, 0.01, t.size)).astype(np.float32)
    want = np.asarray(j_chroma.cq_chroma_multires(jnp.asarray(y), sr=sr))
    got = t_chroma.cq_chroma_multires(torch.from_numpy(y), sr=sr).numpy()
    assert got.shape == want.shape and got.shape[0] == 12
    frame_max = np.abs(want).max(axis=0, keepdims=True)
    assert np.all(np.abs(got - want) <= 1e-5 * frame_max)
    # a batch of two lanes gives each lane's chroma
    both = t_chroma.cq_chroma_multires(torch.from_numpy(np.stack([y, 0.5 * y])), sr=sr).numpy()
    np.testing.assert_allclose(both[0], got, rtol=0, atol=1e-6)


def test_get_version_matches_jax() -> None:
    assert track_analyser_tpu_torch.get_version() == track_analyser_tpu.get_version()


def _shapes(params: dict) -> dict:
    return {k: tuple(np.shape(v)) for k, v in params.items()}


def test_downbeat_entry_point_writes_a_jax_checkpoint(tmp_path) -> None:
    out = tmp_path / "downbeat_ckpt.npz"
    rc = t_db.main(["--steps", "2", "--batch", "2", "--hidden", "16", "--device", "cpu", "--out", str(out)])
    assert rc == 0
    loaded = j_db.load_checkpoint(out)
    assert _shapes(loaded) == _shapes(j_db.init_params(jax.random.PRNGKey(0), hidden=16))
    assert all(np.isfinite(v).all() for v in loaded.values())
    # the JAX forward runs on it
    logits = j_db.forward({k: jnp.asarray(v) for k, v in loaded.items()}, jnp.zeros((40, 128), jnp.float32))
    assert logits.shape == (40, j_db.N_CLASSES)


def test_training_entry_point_writes_a_jax_checkpoint(tmp_path) -> None:
    out = tmp_path / "separation_ckpt.npz"
    rc = t_tr.main(["--steps", "2", "--batch", "2", "--seconds", "0.25", "--device", "cpu", "--out", str(out)])
    assert rc == 0
    loaded = j_sep.load_checkpoint(out)
    dilations = j_sep.checkpoint_dilations(loaded)
    loaded.pop("_dilations", None)
    want = j_sep.init_params(jax.random.PRNGKey(0))
    assert _shapes(loaded) == _shapes(want)
    assert all(np.isfinite(v).all() for v in loaded.values())
    y = np.random.default_rng(4).normal(0.0, 0.1, 8_192).astype(np.float32)
    est = j_sep.separate_signal({k: jnp.asarray(v) for k, v in loaded.items()}, jnp.asarray(y), n_samples=y.size, dilations=dilations)
    assert np.isfinite(np.asarray(est)).all()


@pytest.mark.parametrize("entry", ["downbeat_net", "training"])
def test_training_entry_points_default_to_cuda(entry, monkeypatch, tmp_path) -> None:
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    main = {"downbeat_net": t_db.main, "training": t_tr.main}[entry]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--steps", "1", "--out", str(tmp_path / "ckpt.npz")])
    assert not (tmp_path / "ckpt.npz").exists()


def test_native_build_entry_point(capsys) -> None:
    assert t_build.main([]) == 0
    out = capsys.readouterr().out
    assert "libta_native: built" in out
    assert "libta_ffmpeg: built" in out or "libta_ffmpeg: absent (" in out


def test_native_build_entry_point_reports_a_failed_ffmpeg_build(capsys, monkeypatch) -> None:
    # The ffmpeg tier is best effort: its failed build is printed and the
    # exit code stays that of libta_native.
    def fail():
        raise RuntimeError("ffmpeg.cpp: error: boom")

    monkeypatch.setattr(t_build, "ffmpeg_absent_reason", lambda: None)
    monkeypatch.setattr(t_build, "build_ffmpeg", fail)
    assert t_build.main([]) == 0
    out = capsys.readouterr().out
    assert "libta_native: built" in out
    assert "libta_ffmpeg: absent (build failed: ffmpeg.cpp: error: boom)" in out


def test_native_build_entry_point_fails_with_the_native_build(capsys, monkeypatch) -> None:
    def fail():
        raise RuntimeError("decoder.cpp: error: boom")

    monkeypatch.setattr(t_build, "build_native", fail)
    assert t_build.main([]) == 1
    captured = capsys.readouterr()
    assert "decoder.cpp: error: boom" in captured.err
    assert "libta_ffmpeg" not in captured.out
