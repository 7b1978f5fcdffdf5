"""Whole runs on the CPU at a tiny size: each traffic kind end to end, a
cell and a metric added by files alone, and faults planted under the
timed path that the comparison must catch."""

import hashlib
import json
import shutil
import time
from pathlib import Path

import pytest

from h100_bench.harness import run_cell
from h100_bench.spec import Spec

REPO = Path(__file__).resolve().parents[2]
BENCH = REPO / "h100_bench"


def _toy_root(tmp_path: Path, bench_dir: Path = BENCH) -> Path:
    """A root whose BENCHMARK.json keeps the real metrics and cell names
    but points both configurations at two short files each."""

    data = json.loads((REPO / "BENCHMARK.json").read_text())
    for conf in data["configs"]:
        config = json.loads((REPO / conf["file"]).read_text())
        sr = config["format"]["sample_rate"]
        recipe = "engine" if sr == 22_050 else "club"
        config["corpus"]["tracks"] = [{"recipe": recipe, "seconds": 5, "count": 1},
                                      {"recipe": "sparse_minor", "seconds": 7, "count": 1}]
        (tmp_path / f"{conf['name']}.json").write_text(json.dumps(config))
        conf["file"] = f"{conf['name']}.json"
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(data))
    return tmp_path


def _run(spec: Spec, name: str, seconds: float = 1.0, trace: bool = False) -> dict:
    return run_cell(spec, spec.cell(name), seed=2**31 + 77, seconds=seconds, trace=trace,
                    t0=time.perf_counter(), device="cpu", log=lambda _m: None)


@pytest.mark.parametrize("cell", ["single-cd44k", "sweep-gtzan22k"])
def test_each_traffic_kind_end_to_end(tmp_path, cell):
    spec = Spec(_toy_root(tmp_path))
    out = _run(spec, cell)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 2
    expected = {m.name for m in spec.cell(cell).end_to_end}
    assert set(out["metrics"]) == expected
    assert list(out)[-1] == "checks" and all(v["value"] <= v["limit"] for v in out["checks"].values())


def test_a_cell_and_a_metric_are_added_by_files_alone(tmp_path):
    bench = tmp_path / "bench"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p: hashlib.sha256(p.read_bytes()).hexdigest() for p in bench.rglob("*") if p.is_file()}
    (bench / "traffic" / "sweep_twice.json").write_text(json.dumps({"kind": "sweep", "rotations": 2}))
    (bench / "metrics" / "calls_in_window.py").write_text("def read(ctx):\n    return ctx.window.calls\n")
    root = _toy_root(tmp_path)
    data = json.loads((root / "BENCHMARK.json").read_text())
    data["workloads"].append({"name": "toy-sweep", "config": "cd44k_stereo", "traffic": "sweep_twice",
                              "chips": 1, "why": "a cell added by data"})
    data["end_to_end"].append({"name": "calls_in_window", "unit": "calls", "better": "higher", "bound": 0.25,
                               "source": "host_clock", "workloads": ["toy-sweep"]})
    (root / "BENCHMARK.json").write_text(json.dumps(data))
    out = _run(Spec(root, bench), "toy-sweep")
    assert out["correct"] and out["metrics"]["calls_in_window"]["value"] >= 1
    assert out["attempted"] == 2 * 2 * out["metrics"]["calls_in_window"]["value"]
    after = {p: hashlib.sha256(p.read_bytes()).hexdigest() for p in before}
    assert after == before


def _alter_an_answer(monkeypatch):
    from track_analyser_tpu_torch.parallel import batch

    real = batch.result_from_graph_outputs

    def altered(*args, **kwargs):
        result = real(*args, **kwargs)
        result.loudness.integrated_lufs += 0.05
        return result

    monkeypatch.setattr(batch, "result_from_graph_outputs", altered)


def _answer_unchanged(monkeypatch):
    """Every call after the first returns the first call's state."""

    from track_analyser_tpu_torch import pipeline

    real, held = pipeline.analyse_track, []

    def stale(*args, **kwargs):
        if not held:
            held.append(real(*args, **kwargs))
        return held[0]

    monkeypatch.setattr(pipeline, "analyse_track", stale)


def _half_the_batch(monkeypatch):
    """A sweep that analyses half of its sources and hands their results
    out for the rest."""

    from track_analyser_tpu_torch.parallel import batch

    real = batch.analyse_library

    def half(sources, **kwargs):
        done = real(sources[: len(sources) // 2], **kwargs)
        return done + done[: len(sources) - len(done)]

    monkeypatch.setattr(batch, "analyse_library", half)


@pytest.mark.parametrize("cell, fault", [
    ("single-cd44k", _alter_an_answer),
    ("single-cd44k", _answer_unchanged),
    ("sweep-gtzan22k", _alter_an_answer),
    ("sweep-gtzan22k", _half_the_batch),
])
def test_a_fault_under_the_timed_path_is_not_correct(tmp_path, monkeypatch, cell, fault):
    spec = Spec(_toy_root(tmp_path))
    fault(monkeypatch)
    out = _run(spec, cell)
    assert out["correct"] is False


def test_without_a_card_the_command_exits_and_prints_no_result():
    import subprocess
    import sys

    torch = pytest.importorskip("torch")
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    run = subprocess.run([sys.executable, "-m", "h100_bench.run", "--workload", "sweep-gtzan22k", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert run.returncode != 0 and run.stdout == ""
    assert "needs 1 CUDA card" in run.stderr
