"""The port's out-of-family evaluation (``evaluation.py``) against the JAX
package on the CPU.

The songs come from ``scripts/independent_engine.py`` (loaded by path, as
``tests/test_independent_eval.py`` loads it), rendered as they are, at
22.05 kHz. The thirteen-song gates run on the card (``chip_smoke.py``
phase 17); here the port is held to the JAX package on short songs:

- the metrics equal those of ``scripts/eval_independent.py``,
  ``scripts/eval_independent_dist.py`` and the JAX test's ``_f1``;
- ``check_gates`` passes on the JAX test's measured values and names each
  gate that one value under its floor fails;
- ``evaluation.py`` neither imports nor names the training generators or
  JAX;
- on an 8-bar 3/4 song (seed 1003) and an 8-bar 4/4 song (seed 1000),
  ``evaluate_song(..., device="cpu")`` against the JAX
  ``analyse_track_fused`` + ``separate_stems_arrays``: every result field
  within ``chip_smoke.compare_results`` (the tolerances of
  ``tests/test_agreement.py``; bar positions exact, or an exact tie of
  the bar-position Viterbi that ``equal_score_key`` proves), both F1s
  equal, and each stem's ΔSI-SDR within 1e-3 dB.
"""

from __future__ import annotations

import ast
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import test_independent_eval as jax_eval_test
from chip_smoke import compare_results
from track_analyser_tpu.analysis.stems import separate_stems_arrays as jax_separate
from track_analyser_tpu.parallel.batch import analyse_track_fused as jax_analyse_fused
from track_analyser_tpu.utils import AudioInput as JaxAudioInput
from track_analyser_tpu_torch import evaluation
from track_analyser_tpu_torch.evaluation import (
    DISTRIBUTION_GATES,
    SINGLE_SONG_GATES,
    STEMS,
    SongEval,
    check_gates,
    evaluate_song,
    f1_within,
    si_sdr,
)

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
SR = 22_050
SI_SDR_TOL_DB = 1e-3


def _load(name: str):
    spec = importlib.util.spec_from_file_location(name, REPO / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


engine = _load("independent_engine")
eval_single = _load("eval_independent")
eval_dist = _load("eval_independent_dist")


# ---- the metrics --------------------------------------------------------------------

_RNG = np.random.default_rng(9)
F1_CASES = {
    "empty prediction": (np.array([]), np.arange(8) * 0.5),
    "empty truth": (np.arange(8) * 0.5, np.array([])),
    "both empty": (np.array([]), np.array([])),
    "no hits": (np.arange(8) * 0.5 + 0.2, np.arange(8) * 0.5),
    "exact": (np.arange(8) * 0.5, np.arange(8) * 0.5),
    "on the tolerance": (np.array([0.07, 0.5]), np.array([0.0, 0.5])),
    "jittered, extra and missing": (
        np.sort(np.concatenate([np.arange(40) * 0.49 + _RNG.normal(0, 0.04, 40), [3.33, 7.1]])),
        np.arange(44) * 0.49,
    ),
}


@pytest.mark.parametrize("case", sorted(F1_CASES))
def test_f1_within_matches_the_scripts_and_the_jax_test(case) -> None:
    pred, truth = F1_CASES[case]
    got = f1_within(pred, truth)
    assert got == eval_single.f1_within(pred, truth)
    assert got == eval_dist.f1(pred, truth)
    assert got == jax_eval_test._f1(pred, truth)
    if case in ("empty prediction", "empty truth", "both empty", "no hits"):
        assert got == 0.0


def test_si_sdr_matches_the_scripts() -> None:
    rng = np.random.default_rng(10)
    ref = rng.normal(size=4_000)
    for est in (ref + rng.normal(0, 0.3, ref.size), 0.5 * ref + 0.1, rng.normal(size=ref.size), ref.astype(np.float32)):
        got = si_sdr(est, ref)
        assert got == eval_single.si_sdr(np.asarray(est, np.float64), ref)
        assert got == eval_dist.si_sdr(np.asarray(est, np.float64), ref)


# ---- the gates ----------------------------------------------------------------------


def _row(meter, beat_f1, downbeat_f1, deltas) -> SongEval:
    return SongEval(
        meter=meter, bpm=120.0, decoded_meter=meter, downbeat_source="rnn", beat_f1=beat_f1,
        downbeat_f1=downbeat_f1, delta_si_sdr=dict(deltas),
    )


def _measured_single() -> list:
    """The fixed song as tests/test_independent_eval.py measured it:
    tracked F1 0.995, downbeat F1 0.98, ΔSI-SDR +12.6 / +3.1 / +3.5 / +9.5."""

    return [_row(4, 0.995, 0.98, zip(STEMS, (12.6, 3.1, 3.5, 9.5)))]


def _measured_distribution() -> list:
    """Twelve rows with the JAX test's measured distribution: tracked F1
    median 0.965 min 0.899, downbeat F1 median 0.970 min 0.788, the 3/4
    subset at 0.938 or above, ΔSI-SDR medians +13.5 / +6.3 / +1.4 / +10.7;
    every fourth song and two more at 3/4, as the seeds draw them."""

    meters = [4, 4, 4, 3, 3, 4, 3, 3, 3, 4, 4, 3]
    rows = []
    for k, meter in enumerate(meters):
        beat = 0.899 if k == 1 else 0.965
        down = 0.788 if k == 1 else (0.938 if k == 3 else 0.970)
        rows.append(_row(meter, beat, down, zip(STEMS, (13.5, 6.3, 1.4, 10.7))))
    return rows


def _names(failures: list) -> list:
    return [f.split(":")[0] for f in failures]


def test_gates_pass_on_the_measured_values() -> None:
    assert check_gates(_measured_single(), SINGLE_SONG_GATES) == []
    assert check_gates(_measured_distribution(), DISTRIBUTION_GATES) == []
    assert check_gates(_measured_distribution()) == []  # the distribution gates are the default


def _set(row: SongEval, metric: str, value: float) -> None:
    if metric in STEMS:
        row.delta_si_sdr[metric] = value
    else:
        setattr(row, metric, value)


@pytest.mark.parametrize("gate", SINGLE_SONG_GATES, ids=lambda g: g.name)
def test_single_song_gate_names_its_failure(gate) -> None:
    rows = _measured_single()
    _set(rows[0], gate.metric, gate.floor - 0.01)
    assert _names(check_gates(rows, SINGLE_SONG_GATES)) == [gate.name]


@pytest.mark.parametrize("gate", DISTRIBUTION_GATES, ids=lambda g: g.name)
def test_distribution_gate_names_its_failure(gate) -> None:
    rows = _measured_distribution()
    under = gate.floor - 0.01
    if gate.stat == "min":
        _set(rows[0], gate.metric, under)  # one value under the floor
        expected = [gate.name]
    elif gate.meter is not None:
        for row in rows:
            if row.meter == gate.meter:
                _set(row, gate.metric, under)
        expected = [gate.name]
    else:
        for row in rows:  # a median falls only when half the values do
            _set(row, gate.metric, under)
        expected = [g.name for g in DISTRIBUTION_GATES if g.metric == gate.metric and under < g.floor]
    assert _names(check_gates(rows, DISTRIBUTION_GATES)) == expected


def test_meter_gate_needs_its_rows() -> None:
    rows = _measured_distribution()
    for row in [r for r in rows if r.meter == 3][:3]:
        row.meter = 4
    failures = check_gates(rows, DISTRIBUTION_GATES)
    assert len(failures) == 1 and "3 rows, at least 4 needed" in failures[0]


def test_silent_stems_are_not_scored() -> None:
    rows = _measured_distribution()
    del rows[0].delta_si_sdr["vocals"]
    assert check_gates(rows, DISTRIBUTION_GATES) == []
    single = _measured_single()
    del single[0].delta_si_sdr["vocals"]
    failures = check_gates(single, SINGLE_SONG_GATES)
    assert failures == ["ΔSI-SDR vocals min >= 5.0: 0 rows, at least 1 needed"]


# ---- the import graph ---------------------------------------------------------------


def test_evaluation_names_no_training_generator_and_no_jax() -> None:
    """The gates measure generalisation only while the code that scores
    the songs stays apart from the generators the nets trained on."""

    path = Path(evaluation.__file__)
    source = path.read_text()
    for forbidden in (
        "synthetic_", "synth_percussion", "synth_stems", "tests/synth", "tests.synth", "import synth",
        "from synth", "models.training", "downbeat_net",
    ):
        assert forbidden not in source, forbidden
    assert "jax" not in source.lower()
    imported = set()
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            imported.update(alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom):
            imported.add("." * node.level + (node.module or ""))
    assert imported == {
        "__future__", "time", "dataclasses", "typing", "numpy", "torch",
        ".analysis.stems", ".parallel.batch", ".pipeline", ".utils",
    }, imported


# ---- parity with the JAX package on short songs -------------------------------------

# (seed, meter): a 3/4 song and a 4/4 song of the distribution, 8 bars each
PARITY_SONGS = [(1003, 3), (1000, None)]


@pytest.fixture(scope="module", params=PARITY_SONGS, ids=lambda p: f"seed{p[0]}")
def song(request):
    """(rendered song, the JAX row, the port's row); the JAX side is
    computed once per song."""

    seed, meter = request.param
    stems, mix, beats, bars, meta = engine.render_random_song(seed, sr=SR, bars=8, meter=meter)
    ref = jax_analyse_fused(JaxAudioInput(samples=mix, sample_rate=SR))
    est = jax_separate(mix, SR)
    jax_row = SongEval(
        meter=meta["meter"],
        bpm=float(ref.beat.bpm),
        decoded_meter=int(max(ref.downbeat.beat_positions)),
        downbeat_source=ref.downbeat.source,
        beat_f1=jax_eval_test._f1(np.asarray(ref.beat.tracked_times or []), beats),
        downbeat_f1=jax_eval_test._f1(np.asarray(ref.downbeat.downbeat_times), bars),
        delta_si_sdr={
            n: eval_dist.si_sdr(np.asarray(est[n], np.float64), stems[n].astype(np.float64))
            - eval_dist.si_sdr(mix.astype(np.float64), stems[n].astype(np.float64))
            for n in STEMS
            if float(np.dot(stems[n].astype(np.float64), stems[n].astype(np.float64))) >= 1e-9
        },
        result=ref,
    )
    port_row = evaluate_song(stems, mix, beats, bars, sample_rate=SR, meter=meta["meter"], device="cpu")
    return (stems, mix, beats, bars, meta), jax_row, port_row


def test_song_result_matches_jax(song) -> None:
    (_stems, _mix, _beats, _bars, meta), jax_row, port_row = song
    assert port_row.meter == meta["meter"] and port_row.decoded_meter == jax_row.decoded_meter
    compare_results(port_row.result, jax_row.result, "port vs JAX", rounding_differs=True)
    assert port_row.downbeat_source == jax_row.downbeat_source
    assert abs(port_row.bpm - jax_row.bpm) <= 1e-3


def test_song_f1_matches_jax(song) -> None:
    _song, jax_row, port_row = song
    assert port_row.beat_f1 == jax_row.beat_f1
    assert port_row.downbeat_f1 == jax_row.downbeat_f1


def test_song_separation_matches_jax(song) -> None:
    _song, jax_row, port_row = song
    assert port_row.delta_si_sdr.keys() == jax_row.delta_si_sdr.keys()
    for name, want in jax_row.delta_si_sdr.items():
        assert abs(port_row.delta_si_sdr[name] - want) <= SI_SDR_TOL_DB, (name, port_row.delta_si_sdr[name], want)

