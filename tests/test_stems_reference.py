"""The benchmark's plain stems reference (``h100_bench/reference/stems.py``)
on the CPU, and the spans of the port's stems layer.

One seeded random checkpoint of the bundled v5 net's shapes (15 bands,
width 144, four mixing blocks, dilations 1, 3, 9, 27), written to a
temporary ``separation_v5.npz`` and named by the environment override:

- the reference against the JAX package's ``separate_stems`` (the
  specification), stem for stem in 16-bit steps, on a 3 s mono source
  (each channel is separated on its own, so one channel tells; the JAX
  package's CPU median makes a stereo run cost twice as much);
- the port's ``analyse_track(path, use_stems=True, device="cpu")`` on a
  1 s stereo source, run once under a profiler session, against the
  reference by the benchmark's own numbers, ``stem_lsb`` and
  ``stem_mismatch``, held to the configuration's limits;
- two planted faults (a blend weight changed, one band's decoders
  dropped) that read above the limit;
- the port's stems spans, nested under its ``stems`` span with the
  call's track, and their counters, without ``stems.net_device`` on the
  CPU.

Tolerance: the reference and the JAX package compute the same float32
stems by other routes (``conv1d`` and ``fold`` against shifted sums), so
a sample may round to the neighbouring integer: at most one step.
"""

from __future__ import annotations

import json
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.autograd import profiler as autograd_profiler

from h100_bench import correct
from h100_bench.reference import stems as reference
from track_analyser_tpu.analysis import stems as jstems
from track_analyser_tpu_torch import analyse_track, profiling
from track_analyser_tpu_torch.analysis import stems as tstems
from track_analyser_tpu_torch.io import write_wav
from track_analyser_tpu_torch.models import separation_net as tnet

torch.set_num_threads(2)

SR = 44_100
ENV = "TRACK_ANALYSER_TPU_SEPARATION_CKPT"
CONFIG = Path(__file__).resolve().parents[1] / "h100_bench" / "configs" / "musdb44k_stems.json"
LIMITS = json.loads(CONFIG.read_text())["limits"]
STEM_SPANS = ("stems.load", "stems.net", "stems.dsp", "stems.blend", "stems.write")


def _mixture(n: int, seed: int, channels: int = 2) -> np.ndarray:
    """(channels, n) kicks, a bass tone, a tremolo mid tone and noise, peak 0.9."""

    rng = np.random.default_rng(seed)
    t = np.arange(n) / SR
    rows = []
    for c in range(channels):
        y = 0.3 * np.sin(2 * np.pi * 70.0 * t) + 0.25 * (1 + 0.9 * np.sin(2 * np.pi * 4.0 * t)) * np.sin(
            2 * np.pi * (440.0 + 50.0 * c) * t)
        for b in np.arange(0.0, n / SR, 0.4):
            s = int(b * SR)
            e = min(n, s + 2_000)
            y[s:e] += 0.6 * rng.normal(size=e - s) * np.exp(-np.arange(e - s) / 400.0)
        rows.append(y + 0.01 * rng.normal(size=n))
    x = np.stack(rows)
    return (x * (0.9 / np.abs(x).max())).astype(np.float32)


def _checkpoint(path: Path, seed: int = 19) -> Path:
    model = tnet.init_params(d_model=144, n_blocks=4, dilations=(1, 3, 9, 27),
                             generator=torch.Generator().manual_seed(seed))
    tnet.save_checkpoint(model, path)
    return path


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    root = tmp_path_factory.mktemp("stems_reference")
    (root / "weights").mkdir()
    ckpt = _checkpoint(root / "weights" / "separation_v5.npz")
    source = root / "song.wav"
    write_wav(source, _mixture(SR + 11, seed=19), SR)
    answer = reference.analyse(str(source), device="cpu", control=False, checkpoint=ckpt)
    return SimpleNamespace(root=root, ckpt=ckpt, source=source, answer=answer)


@pytest.fixture(scope="module")
def port_call(case):
    """The port's analyse_track with stems, in a directory of its own,
    under a profiler session (the autograd profiler without Kineto: it
    switches span recording on as ``torch.profiler.profile`` does, at a
    fraction of its cost on the CPU); its result, spans and counters."""

    run_dir = case.root / "call"
    run_dir.mkdir()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv(ENV, str(case.ckpt))
        mp.chdir(run_dir)
        profiling.reset_spans()
        profiling.reset_stage_seconds()
        with autograd_profiler.profile(use_kineto=False):
            result = analyse_track(str(case.source), use_stems=True, device="cpu")
        return SimpleNamespace(result=result, run_dir=run_dir, spans=profiling.spans(),
                               stages=profiling.stage_seconds())


def _numbers(got: dict, ref: dict) -> dict:
    """The reference's numbers over every leaf, as the benchmark folds them."""

    held = correct.Reference.of_module("stems", reference)
    numbers = correct.Numbers([held])
    numbers.add(got, ref, "call", held)
    return {k: v for k, (v, _where) in numbers.worst.items()}


def test_the_reference_is_the_specification(case, tmp_path) -> None:
    source = tmp_path / "mono.wav"
    write_wav(source, _mixture(3 * SR + 77, seed=20, channels=1)[0], SR)
    answer = reference.analyse(str(source), device="cpu", control=False, checkpoint=case.ckpt)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv(ENV, str(case.ckpt))
        bundle = jstems.separate_stems(str(source), tmp_path)
    assert bundle.model_name == reference.MODEL_NAME
    for stem in reference.STEMS:
        theirs = reference.read_pcm16(bundle.stems[stem])
        assert theirs.shape == answer["pcm"][stem].shape == (1, 3 * SR + 77)
        assert np.abs(theirs).max() > 1_000, stem  # a stem with sound in it
        assert reference.stem_lsb(theirs, answer["pcm"][stem]) <= 1, stem


def test_the_port_is_within_the_limits(case, port_call) -> None:
    got = reference.served(port_call.result, source_path=str(case.source), run_dir=port_call.run_dir)
    numbers = _numbers(got, case.answer)
    assert numbers["stem_mismatch"] == 0.0
    assert numbers["stem_lsb"] <= LIMITS["stem_lsb"]
    assert all(Path(p).parent == port_call.run_dir / "stems" for p in port_call.result.stems.stems.values())


def _changed_blend_weight(mp, case, tmp_path) -> None:
    mp.setitem(tstems._BLEND_NEURAL_WEIGHT, "vocals", 0.5)
    mp.setenv(ENV, str(case.ckpt))


def _dropped_band(mp, case, tmp_path) -> None:
    """A checkpoint whose seventh band decodes to zeros for every stem."""

    with np.load(case.ckpt) as data:
        arrays = {k: np.asarray(data[k]) for k in data.files}
    for stem in reference.STEMS:
        arrays[f"dec7_{stem}_w"] = np.zeros_like(arrays[f"dec7_{stem}_w"])
    (tmp_path / "faulty").mkdir()
    path = tmp_path / "faulty" / "separation_v5.npz"
    np.savez(path, **arrays)
    mp.setenv(ENV, str(path))


@pytest.mark.parametrize("fault", [_changed_blend_weight, _dropped_band], ids=["blend weight", "band decoder"])
def test_a_planted_fault_reads_above_the_limit(case, tmp_path, fault) -> None:
    with pytest.MonkeyPatch.context() as mp:
        fault(mp, case, tmp_path)
        bundle = tstems.separate_stems(str(case.source), tmp_path / "stems", device="cpu")
    got = reference.served(SimpleNamespace(stems=bundle), source_path=str(case.source), run_dir=tmp_path)
    numbers = _numbers(got, case.answer)
    assert numbers["stem_mismatch"] == 0.0
    assert numbers["stem_lsb"] > LIMITS["stem_lsb"], numbers


def test_the_stems_spans_nest_under_stems_with_the_calls_track(port_call) -> None:
    by_name = {}
    for r in port_call.spans:
        by_name.setdefault(r.name, []).append(r)
    (call,), (stems,) = by_name["call"], by_name["stems"]
    assert stems.parent_id == call.span_id
    for name in STEM_SPANS:
        (span,) = by_name[name]
        assert span.parent_id == stems.span_id and span.call_id == call.span_id and span.track == 0, name
        assert stems.start_ns <= span.start_ns <= span.end_ns <= stems.end_ns, name


def test_their_counters_are_counted_without_the_device_counter_on_the_cpu(port_call) -> None:
    stages = port_call.stages
    assert all(stages.get(name, 0.0) > 0.0 for name in STEM_SPANS), stages
    assert sum(stages[name] for name in STEM_SPANS) <= stages["stems"]
    assert "stems.net_device" not in stages and "graph" not in stages
