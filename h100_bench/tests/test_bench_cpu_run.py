"""Whole runs on the CPU at a tiny size: each traffic kind end to end, a
cell and a metric added by files alone, a configuration that brings its
own reference, each call judged by the files it wrote in a directory of
its own, and faults planted under the timed path that the comparison
must catch."""

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


def _run(spec: Spec, name: str, seconds: float = 1.0, trace: bool = False, device: str = "cpu") -> dict:
    return run_cell(spec, spec.cell(name), seed=2**31 + 77, seconds=seconds, trace=trace,
                    t0=time.perf_counter(), device=device, log=lambda _m: None)


@pytest.mark.parametrize("cell", ["single-cd44k", "sweep-gtzan22k"])
def test_each_traffic_kind_end_to_end(tmp_path, cell):
    spec = Spec(_toy_root(tmp_path))
    out = _run(spec, cell)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 2
    # every end-to-end metric but the card's memory, which a CPU run has not
    expected = {m.name for m in spec.cell(cell).end_to_end} - {"device_memory_peak_mib"}
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


# What the two configurations compare, field by field: a change that
# drops one fails here.
ANALYSIS_FIELDS = {
    "beat.bpm": "value_gap", "beat.beat_times": "value_gap", "beat.confidence": "value_gap",
    "loudness.integrated_lufs": "value_gap", "loudness.short_term_lufs": "value_gap",
    "loudness.momentary_lufs": "value_gap", "loudness.loudness_range": "value_gap",
    "loudness.true_peak_dbfs": "value_gap", "loudness.rms_dbfs": "value_gap",
    "structure.novelty_curve": "half_steps",
    "harmonic.spectral_balance.low_band": "value_gap", "harmonic.spectral_balance.mid_band": "value_gap",
    "harmonic.spectral_balance.high_band": "value_gap", "harmonic.stereo_image.correlation": "value_gap",
    "harmonic.stereo_image.balance": "value_gap",
    "features.ltas.frequencies": "value_gap", "features.ltas.magnitude": "value_gap",
    "features.spectral_centroid.values": "half_steps",
    "stereo.mid_rms": "value_gap", "stereo.side_rms": "value_gap", "stereo.correlation": "value_gap",
    "stereo.width.low": "value_gap", "stereo.width.mid": "value_gap", "stereo.width.high": "value_gap",
}


@pytest.mark.parametrize("cell", ["single-cd44k", "sweep-gtzan22k"])
def test_the_configurations_compare_their_24_fields_by_two_numbers(tmp_path, monkeypatch, cell):
    from h100_bench import harness

    spec = Spec(_toy_root(tmp_path))
    assert "references" not in spec.cell(cell).config
    made = []
    real = harness.compare

    def kept(*args, **kwargs):
        made.append(real(*args, **kwargs))
        return made[-1]

    monkeypatch.setattr(harness, "compare", kept)
    out = _run(spec, cell)
    assert len(ANALYSIS_FIELDS) == 24
    assert list(made[0].fields) == ["analysis"]
    assert {leaf: row[0] for leaf, row in made[0].fields["analysis"].items()} == ANALYSIS_FIELDS
    assert list(out["checks"]) == ["value_gap", "half_steps"] and out["correct"]


# -- a configuration with references of its own, its calls each in a directory of the run's
STEM_FIXTURE = BENCH / "tests" / "data" / "written_stems.py"


def _stems_root(tmp_path: Path, **config_changes) -> "tuple[Spec, Path]":
    """A copy of the benchmark with the fixture reference added to it, and
    a toy configuration ``toy_stems`` (two 5-7 s CD-format files,
    ``analyse_track(path, use_stems=True)``) with a ``single`` cell
    ``toy-stems``, all added as files and entries."""

    bench = tmp_path / "bench"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(STEM_FIXTURE, bench / "reference" / "written_stems.py")
    root = _toy_root(tmp_path)
    config = json.loads((root / "cd44k_stereo.json").read_text())
    config.update(name="toy_stems", call={"use_stems": True}, references=["written_stems"],
                  limits={**config["limits"], "stem_mismatch": 0})
    config.update(config_changes)
    (bench / "configs" / "toy_stems.json").write_text(json.dumps(config))
    data = json.loads((root / "BENCHMARK.json").read_text())
    data["configs"].append({"name": "toy_stems", "source": "a test", "file": "bench/configs/toy_stems.json",
                            "reduced": [], "why": "stems"})
    data["workloads"].append({"name": "toy-stems", "config": "toy_stems", "traffic": "single", "chips": 1,
                              "why": "stems written in the run's directory"})
    for m in data["end_to_end"]:
        if m["name"] in ("track_ms", "track_ms_p90"):
            m["workloads"].append("toy-stems")
    (root / "BENCHMARK.json").write_text(json.dumps(data))
    return Spec(root, bench), bench


def _device(name: str) -> str:
    if name == "cuda":
        torch = pytest.importorskip("torch")
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA card")
    return name


DEVICES = ["cpu", pytest.param("cuda", marks=pytest.mark.gpu)]


def _record_stem_writes(monkeypatch, zero: str = "") -> list:
    """Records each stem file the program writes; writes the stem named
    ``zero`` as silence."""

    from track_analyser_tpu_torch.analysis import stems

    written, real = [], stems.write_wav

    def write(path, data, *args, **kwargs):
        written.append(Path(path))
        if zero and Path(path).stem.endswith(f"_{zero}"):
            data = data * 0
        return real(path, data, *args, **kwargs)

    monkeypatch.setattr(stems, "write_wav", write)
    return written


@pytest.mark.parametrize("device", DEVICES)
def test_a_configuration_brings_its_reference_and_writes_in_the_run_dir(tmp_path, monkeypatch, device):
    spec, _ = _stems_root(tmp_path)
    here = tmp_path / "started_here"
    here.mkdir()
    monkeypatch.chdir(here)
    written = _record_stem_writes(monkeypatch)
    out = _run(spec, "toy-stems", seconds=6.0, device=_device(device))
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 1, out["checks"]
    assert list(out["checks"]) == ["value_gap", "half_steps", "stem_mismatch"]
    assert out["checks"]["stem_mismatch"] == {"value": 0.0, "limit": 0.0}
    card = {"device_memory_peak_mib"} if device == "cuda" else set()
    assert set(out["metrics"]) == {"track_ms", "track_ms_p90", "setup_s"} | card
    # warm-up, window: four stems a call, in a directory of that call's
    # own under the run's, which went with the run; nothing where the
    # run started
    assert len(written) >= 4 * (1 + out["attempted"])
    assert all(p.parent.name == "stems" for p in written)
    assert len({p.parents[1] for p in written}) == len(written) // 4
    calls = {p.parents[2] for p in written}
    assert len(calls) == 1 and calls.pop().name == "calls"
    assert Path.cwd() == here and not any(here.iterdir())
    assert not any(p.parents[3].exists() for p in written)


def _serve_another_tracks_stems(monkeypatch):
    """Each call's stems are separated from the corpus's other file."""

    from track_analyser_tpu_torch.analysis import stems

    real = stems.separate_stems

    def other(audio_path, *args, **kwargs):
        siblings = sorted(Path(audio_path).parent.glob("*.wav"))
        return real(str(next(p for p in siblings if p.name != Path(audio_path).name)), *args, **kwargs)

    monkeypatch.setattr(stems, "separate_stems", other)


def _write_each_tracks_stems_once(monkeypatch):
    """A track's later calls hand out its first call's stems unwritten:
    the warm-up's files, where they are left, would pass for them."""

    from track_analyser_tpu_torch.analysis import stems

    real, held = stems.separate_stems, {}

    def once(audio_path, *args, **kwargs):
        if audio_path not in held:
            held[audio_path] = real(audio_path, *args, **kwargs)
        return held[audio_path]

    monkeypatch.setattr(stems, "separate_stems", once)


def _zero_stems_until_the_stretch(monkeypatch):
    """Every call before the traced stretch writes its vocals as silence;
    the stretch's calls, on the same tracks, write them whole."""

    from h100_bench.drive import Driver
    from track_analyser_tpu_torch.analysis import stems

    real_write, real_stretch, zeroing = stems.write_wav, Driver.stretch, [True]

    def write(path, data, *args, **kwargs):
        if zeroing[0] and Path(path).stem.endswith("_vocals"):
            data = data * 0
        return real_write(path, data, *args, **kwargs)

    def stretch(self):
        zeroing[0] = False
        return real_stretch(self)

    monkeypatch.setattr(stems, "write_wav", write)
    monkeypatch.setattr(Driver, "stretch", stretch)


STEM_FAULTS = {
    "a stem written as zeros": lambda mp: _record_stem_writes(mp, zero="vocals"),
    "another track's stems": _serve_another_tracks_stems,
    "stems written in the warm-up only": _write_each_tracks_stems_once,
    "a zero stem in the window, rewritten whole in the traced stretch": _zero_stems_until_the_stretch,
}


@pytest.mark.parametrize("device", DEVICES)
@pytest.mark.parametrize("fault", list(STEM_FAULTS))
def test_a_stems_fault_is_not_correct_while_the_analysis_is(tmp_path, monkeypatch, device, fault):
    spec, _ = _stems_root(tmp_path)
    STEM_FAULTS[fault](monkeypatch)
    # 6 s: the first cycle of the corpus, both tracks, lies in the window;
    # the traced stretch then calls each track once more
    out = _run(spec, "toy-stems", seconds=6.0, device=_device(device), trace="stretch" in fault)
    assert out["correct"] is False and out["failed"] == 0
    checks = out["checks"]
    assert checks["stem_mismatch"]["value"] > checks["stem_mismatch"]["limit"]
    assert all(checks[k]["value"] <= checks[k]["limit"] for k in ("value_gap", "half_steps"))


@pytest.mark.parametrize("change, raised", [
    ({"references": ["no_such_reference"]}, FileNotFoundError),
    ({"references": ["../reference/audio"]}, FileNotFoundError),
    ({"references": ["audio"]}, ValueError),
    ({"limits": {"value_gap": 4e-4, "half_steps": 48}}, ValueError),
])
def test_a_configuration_that_cannot_be_held_fails_before_the_window(tmp_path, monkeypatch, change, raised):
    from h100_bench.drive import Driver

    spec, _ = _stems_root(tmp_path, **change)
    monkeypatch.setattr(Driver, "warm", lambda *_: pytest.fail("the run reached its warm-up"))
    with pytest.raises(raised):
        _run(spec, "toy-stems")


LEAVES_LINE = 'LEAVES = {"stems": "stem_mismatch"}\n'


@pytest.mark.parametrize("source, raised, match", [
    (lambda _text: "import no_such_module\n", ImportError, "does not load"),
    (lambda text: text.replace(LEAVES_LINE, ""), ValueError, "names no leaf"),
], ids=["does not load", "names no leaf"])
def test_a_reference_that_does_not_load_fails_before_the_window(tmp_path, monkeypatch, source, raised, match):
    from h100_bench.drive import Driver

    spec, bench = _stems_root(tmp_path)
    module = bench / "reference" / "written_stems.py"
    assert LEAVES_LINE in module.read_text()
    module.write_text(source(module.read_text()))
    monkeypatch.setattr(Driver, "warm", lambda *_: pytest.fail("the run reached its warm-up"))
    with pytest.raises(raised, match=match):
        _run(spec, "toy-stems")


def test_a_leaf_the_reference_does_not_name_stops_the_run(tmp_path):
    spec, bench = _stems_root(tmp_path)
    module = bench / "reference" / "written_stems.py"
    module.write_text(module.read_text().replace(LEAVES_LINE, 'LEAVES = {"stems.drums": "stem_mismatch"}\n'))
    with pytest.raises(ValueError, match="names no number for its leaf 'stems.bass.channels'"):
        _run(spec, "toy-stems")


def test_calibrate_reads_every_reference_for_the_program_and_the_control(tmp_path):
    from h100_bench.calibrate import readings

    spec, _ = _stems_root(tmp_path)
    line = readings(spec, "toy-stems", 2**31 + 78, control=True, device="cpu")
    assert line["served"] == 2
    for side in ("program", "control"):
        assert list(line[side]) == ["value_gap", "half_steps", "stem_mismatch"]
        assert set(line[f"{side}_by_reference"]) == {"analysis", "written_stems"}
        assert list(line[f"{side}_by_reference"]["written_stems"]) == ["stem_mismatch"]
        assert list(line[f"{side}_fields"]) == ["analysis", "written_stems"]
        assert set(line[f"{side}_fields"]["analysis"]) == set(ANALYSIS_FIELDS)
        assert set(line[f"{side}_fields"]["written_stems"]) == {
            f"stems.{s}.{k}" for s in ("drums", "bass", "other", "vocals")
            for k in ("channels", "frames", "sound", "in_run_dir")}
    assert line["program"]["stem_mismatch"][0] == 0.0 and line["control"]["stem_mismatch"][0] == 0.0
    assert line["control"]["value_gap"][0] > line["program"]["value_gap"][0]


def _digests(bench: Path) -> dict:
    return {p.relative_to(bench): hashlib.sha256(p.read_bytes()).hexdigest() for p in bench.rglob("*")
            if p.is_file() and not {"__pycache__", "tests"} & set(p.relative_to(bench).parts)}


def test_a_reference_and_the_run_dir_are_added_by_files_alone(tmp_path):
    spec, bench = _stems_root(tmp_path)
    out = _run(spec, "toy-stems", seconds=2.0)
    assert out["correct"] and list(out["checks"]) == ["value_gap", "half_steps", "stem_mismatch"]
    after = _digests(bench)
    added = {Path("reference/written_stems.py"), Path("configs/toy_stems.json")}
    assert added <= set(after) and {k: v for k, v in after.items() if k not in added} == _digests(BENCH)


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
