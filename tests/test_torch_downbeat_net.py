"""The port's downbeat TCN against the JAX package's, on the CPU.

``params_from_jax`` + ``DownbeatTCN`` against ``tcn_forward`` with random
numpy parameters and with the bundled v2 checkpoint, ``activation_graph``
against ``_activation_graph`` on a bucket-padded signal, and the GRU
checkpoint's ``DownbeatGRU`` (its outputs are held against the JAX
``forward`` in ``test_torch_modules.py``). Float32 convolutions and
matmuls sum in another order in XLA and PyTorch, so the outputs differ in
the last few ulps: probabilities are held at atol 1e-5; logits reach |13|,
where an ulp is ~1e-6, so they are held at 5e-6 of the largest logit.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from track_analyser_tpu.models import downbeat_net as j_net
from track_analyser_tpu_torch.models import downbeat_net as t_net

torch.set_num_threads(2)

CKPT = (
    Path(__file__).resolve().parents[1]
    / "track_analyser_tpu"
    / "models"
    / "checkpoints"
    / "downbeat_tcn_v2.npz"
)


def _random_params(seed: int = 0, n_mels: int = 128, channels: int = 64) -> dict:
    rng = np.random.default_rng(seed)

    def w(*shape):
        return (rng.normal(size=shape) / np.sqrt(shape[0])).astype(np.float32)

    params = {
        "tcn_in_w": w(n_mels, channels),
        "tcn_in_b": w(channels),
        "tcn_out_w": w(channels, 3),
        "tcn_out_b": w(3),
    }
    for i in range(len(j_net.TCN_DILATIONS)):
        params[f"tcn{i}_w"] = w(channels, channels, j_net.TCN_KERNEL)
        params[f"tcn{i}_b"] = w(channels)
        params[f"tcn{i}_pw"] = w(channels, channels)
        params[f"tcn{i}_pb"] = w(channels)
    return params


def _feats(frames: int = 300, seed: int = 1) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=(frames, 128)).astype(np.float32)


@pytest.mark.parametrize("source", ["random", "bundled_v2"])
def test_tcn_forward_matches_jax(source) -> None:
    params = _random_params() if source == "random" else t_net.load_checkpoint(CKPT)
    feats = _feats()
    ref = np.asarray(j_net.tcn_forward({k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(feats)))
    model = t_net.params_from_jax(params)
    with torch.no_grad():
        got = model(torch.from_numpy(feats)).numpy()
    assert got.shape == ref.shape == (feats.shape[0], 3)
    np.testing.assert_allclose(got, ref, rtol=0, atol=5e-6 * np.abs(ref).max())


def test_load_checkpoint_matches_jax() -> None:
    ref = j_net.load_checkpoint(CKPT)
    got = t_net.load_checkpoint(CKPT)
    assert sorted(got) == sorted(ref)
    for key in ref:
        np.testing.assert_array_equal(got[key], ref[key])


def test_activation_graph_matches_jax_on_padded_signal() -> None:
    """Two lanes of different valid lengths in one batch, each against
    the JAX graph of that lane alone."""

    sr = 22_050
    rng = np.random.default_rng(2)
    n_valids = (3 * sr + 123, 2 * sr + 4_567)
    lanes = np.zeros((2, 4 * sr), dtype=np.float32)  # zero padding beyond n_valid
    for lane, n_valid in zip(lanes, n_valids):
        t = np.arange(n_valid) / sr
        lane[:n_valid] = 0.2 * np.sin(2 * np.pi * 180.0 * t) + 0.05 * rng.normal(size=n_valid)
        for start in range(0, n_valid, sr // 2):
            lane[start : min(start + 400, n_valid)] += 0.7 * np.exp(-np.arange(min(400, n_valid - start)) / 80.0)

    params = t_net.load_checkpoint(CKPT)
    with torch.no_grad():
        got = t_net.activation_graph(
            t_net.params_from_jax(params), torch.from_numpy(lanes), torch.tensor(n_valids), sr=sr
        ).numpy()
    for b, n_valid in enumerate(n_valids):
        ref = np.asarray(
            j_net._activation_graph(
                {k: jnp.asarray(v) for k, v in params.items()},
                jnp.asarray(lanes[b]),
                jnp.asarray(n_valid),
                sr=sr,
            )
        )
        assert got[b].shape == ref.shape
        f_valid = 1 + n_valid // 512
        assert np.all(got[b, f_valid:] == 0.0)
        np.testing.assert_allclose(got[b], ref, rtol=0, atol=1e-5)


def test_gru_checkpoint_serves_the_per_module_path_only(monkeypatch) -> None:
    """The GRU checkpoint builds a ``DownbeatGRU`` whose ``nn.GRU`` holds
    the JAX weights transposed with a zero hidden bias; the fused path
    leaves it out unless TRACK_ANALYSER_TPU_NET_DOWNBEATS=1."""

    from track_analyser_tpu_torch.models import downbeat as t_downbeat
    from track_analyser_tpu_torch.parallel import batch as tb

    gru_ckpt = CKPT.with_name("downbeat_v1.npz")
    params = t_net.load_checkpoint(gru_ckpt)
    model = t_net.params_from_jax(params)
    assert isinstance(model, t_net.DownbeatGRU)
    for layer in (0, 1):
        np.testing.assert_array_equal(getattr(model.gru, f"weight_ih_l{layer}").detach().numpy(), params[f"gru{layer}_wx"].T)
        np.testing.assert_array_equal(getattr(model.gru, f"weight_hh_l{layer}").detach().numpy(), params[f"gru{layer}_wh"].T)
        np.testing.assert_array_equal(getattr(model.gru, f"bias_ih_l{layer}").detach().numpy(), params[f"gru{layer}_b"])
        assert not getattr(model.gru, f"bias_hh_l{layer}").detach().any()

    monkeypatch.setenv("TRACK_ANALYSER_TPU_DOWNBEAT_CKPT", str(gru_ckpt))
    monkeypatch.delenv("TRACK_ANALYSER_TPU_NET_DOWNBEATS", raising=False)
    assert t_downbeat._net_params() is not None
    assert tb._bundled_net(torch.device("cpu")) is None
    monkeypatch.setenv("TRACK_ANALYSER_TPU_NET_DOWNBEATS", "1")
    assert isinstance(tb._bundled_net(torch.device("cpu")), t_net.DownbeatGRU)
    monkeypatch.setenv("TRACK_ANALYSER_TPU_NET_DOWNBEATS", "0")
    assert tb._bundled_net(torch.device("cpu")) is None
