"""The port's training code against the JAX package's, on the CPU.

* The synthetic data (``synthetic_batch``, ``synth_percussion``,
  ``synth_stems``) is numpy from a seeded generator in both packages:
  bit-equal. ``logmel_features`` goes through the port's STFT and mel ops:
  within 1e-4 of JAX's standardised features.
* The downbeat nets (the GRU at hidden 16 and the TCN), from the same
  parameters (``params_from_jax``): the loss and one SGD-with-momentum
  step (the updated parameters and the momentum) within 1e-5 of JAX's,
  relative to each array's largest |value|.
* The separation net at a narrow width (one block, width 16, 0.25 s,
  batch 2), from the same parameters: the loss within 1e-6 relative; one
  Adam step's first and second moments (0.1 g and 0.001 g^2: the
  gradient) within 1e-5 / 2e-5 of their largest |value|. Adam then
  divides each entry by its own |g|: where |g| is far above eps (1e-8)
  the updated parameters agree within 1e-3 of the learning rate, while an
  entry whose |g| sits near eps moves by lr * g / (|g| + eps), which
  carries the gradients' float32 rounding (a few 1e-9 here) unscaled, so
  there both steps are only held to the step's own bound, |update| <= lr
  (plus the float32 rounding of p - update).
* Checkpoints saved by either package load in the other and give the
  same forward output; the GRU's frozen zero ``bias_hh``.
* ``train_downbeat`` and ``train_separation`` run a few steps.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from track_analyser_tpu.models import downbeat_net as j_db
from track_analyser_tpu.models import separation_net as j_sep
from track_analyser_tpu.models import training as j_tr
from track_analyser_tpu_torch.models import downbeat_net as t_db
from track_analyser_tpu_torch.models import separation_net as t_sep
from track_analyser_tpu_torch.models import training as t_tr

torch.set_num_threads(2)

STEP_TOL = 1e-5
LR_SEP = 3e-4


def _rel(got, want) -> float:
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64)
    return float(np.max(np.abs(got - want)) / max(float(np.max(np.abs(want))), 1e-30))


def _jnp(params: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in params.items()}


# ---- synthetic data ---------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 7])
def test_synthetic_batch_is_bit_equal(seed) -> None:
    got = t_db.synthetic_batch(np.random.default_rng(seed), batch=3, frames=128, n_mels=64)
    want = j_db.synthetic_batch(np.random.default_rng(seed), batch=3, frames=128, n_mels=64)
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])


@pytest.mark.parametrize("style,rhythm", [(None, None), ("backbeat", "complex"), ("accent", "auto")])
def test_synth_percussion_is_bit_equal(style, rhythm) -> None:
    got = t_db.synth_percussion(np.random.default_rng(3), seconds=3.0, style=style, rhythm=rhythm, return_downbeat_mask=True)
    want = j_db.synth_percussion(np.random.default_rng(3), seconds=3.0, style=style, rhythm=rhythm, return_downbeat_mask=True)
    for a, b in zip(got, want):
        assert np.array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("seed", [0, 5])
def test_synth_stems_is_bit_equal(seed) -> None:
    got = t_tr.synth_stems(np.random.default_rng(seed), 0.5)
    want = j_tr.synth_stems(np.random.default_rng(seed), 0.5)
    assert got.dtype == want.dtype == np.float32
    assert np.array_equal(got, want)


@pytest.mark.parametrize("name", ["logmel_features", "synthetic_audio_example", "synthetic_audio_batch", "train_downbeat"])
def test_audio_front_end_defaults_to_the_card(name) -> None:
    """Like every entry point of the port, these run on CUDA unless the
    caller asks for the CPU (and raise where CUDA is absent)."""

    import inspect

    assert inspect.signature(getattr(t_db, name)).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            t_db.logmel_features(np.zeros(4096, dtype=np.float32))


def test_synthetic_audio_batch_matches_jax() -> None:
    """The same audio and labels; the log-mel features within 1e-4 (they
    are standardised, so of order 1)."""

    got = t_db.synthetic_audio_batch(np.random.default_rng(4), batch=2, frames=96, device="cpu")
    want = j_db.synthetic_audio_batch(np.random.default_rng(4), batch=2, frames=96)
    assert np.array_equal(got[1], want[1])
    assert got[0].shape == want[0].shape
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-4)


# ---- the downbeat nets --------------------------------------------------------------

def _net(kind: str):
    gen = torch.Generator().manual_seed(3)
    if kind == "gru":
        return t_db.init_params(n_mels=32, hidden=16, generator=gen)
    return t_db.init_tcn_params(n_mels=32, channels=8, generator=gen)


@pytest.fixture(scope="module", params=["gru", "tcn"])
def downbeat_step(request):
    """(port: loss, params, momentum; JAX: the same) after one step from
    the same parameters and batch."""

    model = _net(request.param)
    p0 = t_db.params_to_jax(model)
    feats, labels = t_db.synthetic_batch(np.random.default_rng(1), batch=3, frames=96, n_mels=32)
    jp, jm, jloss = j_db.train_step(_jnp(p0), {k: jnp.zeros_like(v) for k, v in _jnp(p0).items()}, feats, labels)
    momentum = t_db.init_momentum(model)
    model, momentum, loss = t_db.train_step(model, momentum, feats, labels)
    return {
        "kind": request.param,
        "loss": float(loss),
        "params": t_db.params_to_jax(model),
        "momentum": _momentum_to_jax(model, momentum),
        "jax_loss": float(jloss),
        "jax_params": {k: np.asarray(v) for k, v in jp.items()},
        "jax_momentum": {k: np.asarray(v) for k, v in jm.items()},
        "p0": p0,
        "feats": feats,
        "labels": labels,
    }


def _momentum_to_jax(model, momentum: dict) -> dict:
    """The momentum in the JAX layout: swap it into the parameters and
    read them out through ``params_to_jax``."""

    clone = type(model)(**_shape_kwargs(model))
    with torch.no_grad():
        for name, p in clone.named_parameters():
            p.copy_(momentum[name] if name in momentum else torch.zeros_like(p))
    return t_db.params_to_jax(clone)


def _shape_kwargs(model) -> dict:
    if isinstance(model, t_db.DownbeatTCN):
        return {"n_mels": model.inp.in_features, "channels": model.inp.out_features}
    return {"n_mels": model.inp.in_features, "hidden": model.inp.out_features}


def test_downbeat_loss_matches_jax(downbeat_step) -> None:
    s = downbeat_step
    model = t_db.params_from_jax(s["p0"])
    want = float(j_db.loss_fn(_jnp(s["p0"]), s["feats"], s["labels"]))
    got = float(t_db.loss_fn(model, s["feats"], s["labels"]).detach())
    assert got == pytest.approx(want, rel=1e-6)
    assert s["loss"] == pytest.approx(s["jax_loss"], rel=STEP_TOL)


def test_downbeat_train_step_matches_jax(downbeat_step) -> None:
    s = downbeat_step
    assert sorted(s["params"]) == sorted(s["jax_params"])
    for k, want in s["jax_params"].items():
        assert _rel(s["params"][k], want) <= STEP_TOL, k
        assert _rel(s["momentum"][k], s["jax_momentum"][k]) <= STEP_TOL, k
    moved = [k for k in s["p0"] if not np.array_equal(s["params"][k], s["p0"][k])]
    assert sorted(moved) == sorted(s["p0"]), "every parameter takes a step"


def _expected_std(name: str, shape: tuple) -> float:
    """The spread JAX's initialisers draw at: zero for biases, 0.1 for the
    separator's depthwise taps, He (fan C*K) for the TCN's dilated convs,
    else Glorot, sqrt(2 / (fan_in + fan_out))."""

    if name.endswith("_b") or name.endswith("_pb"):
        return 0.0
    if name.endswith("_tconv"):
        return 0.1
    if len(shape) == 3:
        return float(np.sqrt(2.0 / (shape[1] * shape[2])))
    return float(np.sqrt(2.0 / (shape[0] + shape[-1])))


def _assert_init_like_jax(got: dict, jax_init) -> None:
    """The same keys and shapes as JAX's init (traced, not drawn), and
    each array's spread at its initialiser's scale."""

    shapes = jax.eval_shape(jax_init, jax.random.PRNGKey(0))
    assert {k: v.shape for k, v in got.items()} == {k: tuple(v.shape) for k, v in shapes.items()}
    for k, v in got.items():
        want = _expected_std(k, v.shape)
        if want == 0.0:
            assert not np.any(v), k
        else:
            assert float(np.std(v)) == pytest.approx(want, rel=0.25), k


@pytest.mark.parametrize("kind", ["gru", "tcn"])
def test_init_matches_jax_shapes_and_scales(kind) -> None:
    if kind == "gru":
        got = t_db.params_to_jax(t_db.init_params(n_mels=64, hidden=32))
        _assert_init_like_jax(got, lambda k: j_db.init_params(k, n_mels=64, hidden=32))
    else:
        got = t_db.params_to_jax(t_db.init_tcn_params(n_mels=64, channels=32))
        _assert_init_like_jax(got, lambda k: j_db.init_tcn_params(k, n_mels=64, channels=32))


def test_params_to_jax_inverts_params_from_jax() -> None:
    for model in (_net("gru"), _net("tcn")):
        params = t_db.params_to_jax(model)
        back = t_db.params_to_jax(t_db.params_from_jax(params))
        assert all(np.array_equal(params[k], back[k]) for k in params)


def test_gru_bias_hh_is_frozen_at_zero_and_refused_otherwise() -> None:
    model = _net("gru")
    for layer in (0, 1):
        bias = getattr(model.gru, f"bias_hh_l{layer}")
        assert not bias.requires_grad and not bool(bias.any())
    feats, labels = t_db.synthetic_batch(np.random.default_rng(2), batch=2, frames=48, n_mels=32)
    model, _, _ = t_db.train_step(model, t_db.init_momentum(model), feats, labels)
    assert not bool(model.gru.bias_hh_l0.any())
    with torch.no_grad():
        model.gru.bias_hh_l1[0] = 0.5
    with pytest.raises(ValueError, match="bias_hh_l1"):
        t_db.params_to_jax(model)


@pytest.mark.parametrize("kind", ["gru", "tcn"])
def test_downbeat_checkpoints_load_across_packages(kind, tmp_path) -> None:
    model = _net(kind)
    feats = np.random.default_rng(6).normal(size=(80, 32)).astype(np.float32)
    # port -> JAX
    t_db.save_checkpoint(model, tmp_path / "port.npz")
    from_port = j_db.load_checkpoint(tmp_path / "port.npz")
    want = np.asarray(j_db.forward(_jnp(from_port), jnp.asarray(feats)))
    with torch.no_grad():
        got = model(torch.from_numpy(feats)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-6 * np.abs(want).max())
    # JAX -> port
    j_db.save_checkpoint(_jnp(t_db.params_to_jax(model)), tmp_path / "jax.npz")
    loaded = t_db.params_from_jax(t_db.load_checkpoint(tmp_path / "jax.npz"))
    with torch.no_grad():
        assert np.array_equal(loaded(torch.from_numpy(feats)).numpy(), got)


def test_train_downbeat_runs(tmp_path) -> None:
    model, losses = t_db.train_downbeat(
        3, batch=2, frames=64, hidden=8, seed=1, checkpoint_path=tmp_path / "db.npz", log_every=0, device="cpu"
    )
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert sorted(j_db.load_checkpoint(tmp_path / "db.npz")) == sorted(t_db.params_to_jax(model))


# ---- the separation net -------------------------------------------------------------

@pytest.fixture(scope="module")
def separation_step():
    """One Adam step of both packages from the same narrow net and batch."""

    model = t_sep.init_params(d_model=16, n_blocks=1, generator=torch.Generator().manual_seed(5))
    p0 = t_sep.params_to_jax(model)
    rng = np.random.default_rng(2)
    stems = np.stack([t_tr.synth_stems(rng, 0.25) for _ in range(2)])
    mix = stems.sum(axis=1)
    jp, (jm, jv, jstep), jloss = j_tr.separation_train_step(
        _jnp(p0), j_tr.init_opt_state(_jnp(p0)), jnp.asarray(mix), jnp.asarray(stems)
    )
    model, (m, v, step), loss = t_tr.separation_train_step(model, t_tr.init_opt_state(model), mix, stems)
    prefix = len("p.")
    return {
        "p0": p0,
        "loss": float(loss),
        "params": t_sep.params_to_jax(model),
        "m": {k[prefix:]: t.numpy() for k, t in m.items()},
        "v": {k[prefix:]: t.numpy() for k, t in v.items()},
        "step": step,
        "jax_loss": float(jloss),
        "jax_params": {k: np.asarray(x) for k, x in jp.items()},
        "jax_m": {k: np.asarray(x) for k, x in jm.items()},
        "jax_v": {k: np.asarray(x) for k, x in jv.items()},
        "jax_step": int(jstep),
    }


def test_separation_loss_matches_jax(separation_step) -> None:
    s = separation_step
    assert s["loss"] == pytest.approx(s["jax_loss"], rel=1e-6)


def test_separation_gradients_match_jax(separation_step) -> None:
    """Adam's moments after one step: 0.1 g and 0.001 g^2."""

    s = separation_step
    assert s["step"] == s["jax_step"] == 1
    assert sorted(s["m"]) == sorted(s["jax_m"])
    m_scale = max(float(np.abs(x).max()) for x in s["jax_m"].values())
    v_scale = max(float(np.abs(x).max()) for x in s["jax_v"].values())
    for k in s["jax_m"]:
        assert float(np.abs(s["m"][k] - s["jax_m"][k]).max()) <= 1e-5 * m_scale, k
        assert float(np.abs(s["v"][k] - s["jax_v"][k]).max()) <= 2e-5 * v_scale, k


def test_separation_adam_step_matches_jax(separation_step) -> None:
    s = separation_step
    for k, want in s["jax_params"].items():
        got, p0 = s["params"][k], s["p0"][k]
        g = s["jax_m"][k] / 0.1
        far = np.abs(g) >= 100 * 1e-8
        assert float(np.abs(got - want)[far].max(initial=0.0)) <= 1e-3 * LR_SEP, k
        # |lr * m_hat / (sqrt(v_hat) + eps)| <= lr, plus the rounding of p - update
        bound = LR_SEP + 2 * np.spacing(np.abs(p0))
        assert bool(np.all(np.abs(got - p0) <= bound)), k
        assert bool(np.all(np.abs(want - p0) <= bound)), k


def test_separation_init_matches_jax_shapes_and_scales() -> None:
    _assert_init_like_jax(t_sep.params_to_jax(t_sep.init_params()), lambda k: j_sep.init_params(k))


def test_separation_checkpoints_load_across_packages(tmp_path) -> None:
    """A port checkpoint (with its dilations) separates in JAX as in the
    port, and a JAX checkpoint loads in the port."""

    model = t_sep.init_params(d_model=16, n_blocks=2, dilations=(1, 3), generator=torch.Generator().manual_seed(8))
    y = np.random.default_rng(9).normal(0, 0.1, 8192).astype(np.float32)
    t_sep.save_checkpoint(model, tmp_path / "port.npz")
    loaded = j_sep.load_checkpoint(tmp_path / "port.npz")
    dilations = j_sep.checkpoint_dilations(loaded)
    assert dilations == (1, 3)
    loaded.pop("_dilations")
    want = np.asarray(j_sep.separate_signal(_jnp(loaded), jnp.asarray(y), n_samples=y.size, dilations=dilations))
    got = t_sep.separate_signal(model, torch.from_numpy(y), n_samples=y.size).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
    j_sep.save_checkpoint(_jnp(t_sep.params_to_jax(model)), tmp_path / "jax.npz", dilations=(1, 3))
    back = t_sep.params_from_jax(t_sep.load_checkpoint(tmp_path / "jax.npz"))
    assert back.dilations == (1, 3)
    assert np.array_equal(t_sep.separate_signal(back, torch.from_numpy(y), n_samples=y.size).numpy(), got)


def test_train_separation_runs(tmp_path) -> None:
    model, losses = t_tr.train_separation(
        2, batch=1, seconds=0.25, seed=3, checkpoint_path=tmp_path / "sep.npz", log_every=0, device="cpu"
    )
    assert len(losses) == 2 and all(np.isfinite(losses))
    loaded = t_sep.load_checkpoint(tmp_path / "sep.npz")
    assert t_sep.checkpoint_dilations(loaded) == (1, 1)
    assert sorted(k for k in loaded if k != "_dilations") == sorted(t_sep.params_to_jax(model))
