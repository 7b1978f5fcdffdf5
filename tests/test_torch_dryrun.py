"""The port's multi-process dry run (``track_analyser_tpu_torch.dryrun``)
at world 4 under gloo on the CPU: dp 2 x tp 2.

One run of the four ranks serves the module (with a time limit: a hung
rank fails the tests instead of hanging the run). Held:

* the dp analysis: each rank's lane of the batched ``full_track_graph``,
  all-gathered, against the graph run here on the whole batch, within
  1e-6 of each curve's largest |value|;
* the dp x tp step of the GRU net (hidden 256): its loss and every
  updated parameter within 1e-5 (relative to the array's largest |value|)
  of one single-process ``downbeat_net.train_step`` on the whole batch,
  and of the JAX package's ``train_step`` from the same parameters;
* the sequence-sharded analysis of the 30 s click track: the same result
  on every rank, 120 BPM, and the fused path's BPM (within 0.01), key and
  integrated loudness (0.02 LU);
* the dry run's own summary and checks (``summarise``) pass, and fail on
  a dp lane, a step or a rank that differs.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from track_analyser_tpu_torch import dryrun

torch.set_num_threads(2)

WORLD = 4
TIMEOUT_S = 300.0


@pytest.fixture(scope="module")
def reports():
    return dryrun.run_dryrun(WORLD, device="cpu", timeout_s=TIMEOUT_S)


@pytest.fixture(scope="module")
def single():
    return dryrun.single_process_step(WORLD, "cpu")


def test_layout_is_dp2_tp2(reports) -> None:
    assert [r["rank"] for r in reports] == list(range(WORLD))
    assert all(r["backend"] == "gloo" and r["device"] == "cpu" for r in reports)
    step = reports[0]["step"]
    assert (step["dp"], step["tp"]) == (2, 2)


def test_dp_analysis_matches_the_whole_batch(reports) -> None:
    from track_analyser_tpu_torch.substrate import full_track_graph

    stereo, valids = dryrun.dp_batch(WORLD)
    with torch.inference_mode():
        out = full_track_graph(torch.from_numpy(stereo), torch.from_numpy(valids), sr=dryrun.DP_SR)
    env = out["onset_env"].numpy()
    for r in reports:
        got = r["dp_onset_env"]
        assert got.shape == env.shape
        np.testing.assert_allclose(got, env, rtol=0, atol=1e-6 * np.abs(env).max())
        np.testing.assert_allclose(r["dp_lufs"], out["integrated_lufs"].numpy(), rtol=0, atol=1e-4)


def test_dp_tp_step_equals_the_single_process_step(reports, single) -> None:
    for r in reports:
        assert dryrun.step_mismatch(r["step"], single) is None


def test_dp_tp_step_matches_jax(reports, single) -> None:
    """The JAX package's ``train_step`` from the same initial parameters
    on the same batch."""

    import jax.numpy as jnp

    from track_analyser_tpu.models import downbeat_net as j_db
    from track_analyser_tpu_torch.models import downbeat_net as t_db

    p0 = t_db.params_to_jax(
        t_db.init_params(n_mels=dryrun.N_MELS, hidden=dryrun.HIDDEN, generator=torch.Generator().manual_seed(0))
    )
    feats, labels = dryrun.train_batch(2)
    params = {k: jnp.asarray(v) for k, v in p0.items()}
    jp, _, jloss = j_db.train_step(params, {k: jnp.zeros_like(v) for k, v in params.items()}, feats, labels)
    got = reports[0]["step"]
    assert got["loss"] == pytest.approx(float(jloss), rel=dryrun.STEP_TOL)
    for k, want in jp.items():
        want = np.asarray(want)
        assert float(np.abs(got["params"][k] - want).max()) <= dryrun.STEP_TOL * float(np.abs(want).max()), k


def test_every_parameter_moved(reports) -> None:
    from track_analyser_tpu_torch.models import downbeat_net as t_db

    p0 = t_db.params_to_jax(
        t_db.init_params(n_mels=dryrun.N_MELS, hidden=dryrun.HIDDEN, generator=torch.Generator().manual_seed(0))
    )
    got = reports[0]["step"]["params"]
    assert sorted(got) == sorted(p0)
    assert all(not np.array_equal(got[k], p0[k]) for k in p0)


def test_seq_sharded_analysis(reports) -> None:
    from track_analyser_tpu_torch.parallel.batch import analyse_track_fused
    from track_analyser_tpu_torch.utils import AudioInput

    bpms = {r["seq_bpm"] for r in reports}
    assert len(bpms) == 1 and len({r["seq_key"] for r in reports}) == 1
    fused = analyse_track_fused(
        AudioInput(samples=dryrun.seq_track(), sample_rate=dryrun.SEQ_SR), transport="float32", device="cpu"
    )
    assert reports[0]["seq_bpm"] == pytest.approx(120.0, abs=0.1)
    assert reports[0]["seq_bpm"] == pytest.approx(fused.beat.bpm, abs=0.01)
    assert reports[0]["seq_key"] == fused.harmonic.primary_key.key
    assert reports[0]["seq_lufs"] == pytest.approx(fused.loudness.integrated_lufs, abs=0.02)


def test_summary_passes(reports, capsys) -> None:
    assert dryrun.summarise(reports, "cpu") == 0
    lines = capsys.readouterr().out.splitlines()
    assert any("dp analysis: batch=4 over 4 ranks OK against one batched graph" in line for line in lines)
    assert any("dp=2 x tp=2 training step OK" in line for line in lines)
    assert any("seq-sharded analysis over 4 ranks OK" in line for line in lines)


def test_summary_fails_on_a_step_that_differs(reports, capsys) -> None:
    bad = [dict(r) for r in reports]
    bad[0] = dict(bad[0], step=dict(bad[0]["step"], loss=bad[0]["step"]["loss"] * 1.01))
    assert dryrun.summarise(bad, "cpu") == 1
    assert "differs from the single-process step" in capsys.readouterr().out


def test_summary_fails_on_a_dp_lane_that_differs(reports, capsys) -> None:
    bad = [dict(r) for r in reports]
    env = bad[0]["dp_onset_env"].copy()
    env[1, env.shape[1] // 2] += 1e-3 * np.abs(env).max()
    bad = [dict(r, dp_onset_env=env) for r in bad]
    assert dryrun.summarise(bad, "cpu") == 1
    assert "dp analysis differs from one batched graph: onset_env" in capsys.readouterr().out


def test_summary_fails_on_ranks_that_disagree(reports, capsys) -> None:
    bad = [dict(r) for r in reports]
    bad[-1] = dict(bad[-1], dp_lufs=bad[-1]["dp_lufs"] + 1.0)
    assert dryrun.summarise(bad, "cpu") == 1
    assert f"rank {WORLD - 1}'s gathered outputs differ from rank 0's" in capsys.readouterr().out
