"""The stems deployment (``musdb44k_stems``, the cell ``stems-musdb44k``) on
the CPU at a tiny size, and its seven readers.

- A toy copy of the configuration (two 5-7 s CD-format files, as
  ``_toy_root`` cuts every configuration) runs end to end through the
  plain stems reference and reads ``correct: true`` with the checks
  ``value_gap``, ``half_steps``, ``stem_lsb``, ``stem_mismatch``.
- Three faults under the timed path read ``correct: false`` while the
  analysis stays within its limits: a silent stem, stems from the DSP
  separator alone (the net's checkpoint missing), and stems written
  outside the call's own directory.
- The readers read a hand-built run with known answers, and nothing
  where their counter, span or kernel is absent.
"""

import importlib.util
from pathlib import Path

import pytest

from h100_bench.drive import Outcome, Window
from h100_bench.gen.corpus import Track
from h100_bench.harness import Context
from h100_bench.spec import Spec
from h100_bench.tests.test_bench_cpu_run import DEVICES, _device, _record_stem_writes, _run, _toy_root
from h100_bench.trace import Trace

BENCH = Path(__file__).resolve().parents[1]
CELL = "stems-musdb44k"
CHECKS = ["value_gap", "half_steps", "stem_lsb", "stem_mismatch"]
COUNTERS = {"stems_ms.stems": "stems", "stems_net_ms.stems": "stems.net",
            "stems_net_device_ms.stems": "stems.net_device", "stems_dsp_ms.stems": "stems.dsp",
            "stems_write_ms.stems": "stems.write"}
READERS = list(COUNTERS) + ["device_idle_pct.stems", "median31_roofline.stems"]


def reader(name):
    spec = importlib.util.spec_from_file_location(name, BENCH / "metrics" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_the_cell_is_declared_as_files_and_entries():
    spec = Spec(BENCH.parent)
    cell = spec.cell(CELL)
    assert cell.chips == 1 and cell.traffic["kind"] == "single"
    assert cell.config["call"] == {"use_stems": True} and cell.config["references"] == ["stems"]
    assert [m.name for m in cell.end_to_end] == ["track_ms", "device_memory_peak_mib", "setup_s"]
    assert [m.name for m in cell.per_layer] == READERS
    assert [r.name for r in spec.references(cell)] == ["analysis", "stems"]
    assert list(cell.config["limits"]) == CHECKS


@pytest.mark.parametrize("device", DEVICES)
def test_a_toy_copy_reads_correct(tmp_path, monkeypatch, device):
    spec = Spec(_toy_root(tmp_path))
    written = _record_stem_writes(monkeypatch)
    out = _run(spec, CELL, seconds=4.0, device=_device(device))
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 1, out["checks"]
    assert list(out["checks"]) == CHECKS
    assert out["checks"]["stem_mismatch"]["value"] == 0.0
    assert len(written) >= 4 * out["attempted"] and all(p.parent.name == "stems" for p in written)


def _silent_vocals(monkeypatch, _tmp_path):
    _record_stem_writes(monkeypatch, zero="vocals")


def _no_checkpoint(monkeypatch, _tmp_path):
    """The net's checkpoint is missing: the program falls back to the DSP
    separator alone."""

    from track_analyser_tpu_torch.models import separation

    monkeypatch.delenv("TRACK_ANALYSER_TPU_SEPARATION_CKPT", raising=False)
    monkeypatch.setattr(separation, "_BUNDLED", ())


def _written_elsewhere(monkeypatch, tmp_path):
    """Every call writes its stems into one directory outside its own."""

    from track_analyser_tpu_torch.analysis import stems

    real, elsewhere = stems.separate_stems, tmp_path / "elsewhere"

    def moved(audio_path, _output_dir, **kwargs):
        return real(audio_path, elsewhere, **kwargs)

    monkeypatch.setattr(stems, "separate_stems", moved)


FAULTS = {"a silent stem": (_silent_vocals, "stem_lsb"),
          "the DSP separator alone": (_no_checkpoint, "stem_mismatch"),
          "stems outside the call's directory": (_written_elsewhere, "stem_mismatch")}


@pytest.mark.parametrize("device", DEVICES)
@pytest.mark.parametrize("fault", list(FAULTS))
def test_a_stems_fault_is_not_correct(tmp_path, monkeypatch, device, fault):
    plant, number = FAULTS[fault]
    spec = Spec(_toy_root(tmp_path))
    plant(monkeypatch, tmp_path)
    out = _run(spec, CELL, seconds=4.0, device=_device(device))
    checks = out["checks"]
    assert out["correct"] is False and out["failed"] == 0
    assert checks[number]["value"] > checks[number]["limit"]
    assert all(checks[k]["value"] <= checks[k]["limit"] for k in ("value_gap", "half_steps"))


# -- the readers ----------------------------------------------------------------------
SECONDS = (150, 360)
STAGES = {"stems": 6.0, "stems.net": 0.5, "stems.net_device": 0.125, "stems.dsp": 0.25, "stems.write": 3.0,
          "graph": 0.05}


def _ctx(stages=None, trace=None):
    tracks = [Track(i, f"t{i}.wav", "club", s, 44_100, 2, s * 44_100) for i, s in enumerate(SECONDS)]
    served = [Outcome(0, object(), latency_s=2.0), Outcome(1, object(), latency_s=4.0)]
    return Context(CELL, 1.0, Window(6.0, 2, served), tracks, dict(STAGES if stages is None else stages),
                   trace, served)


def _trace(median_us=(100.0, 300.0, 2000.0, 5000.0)):
    device = [["kernel", "median31_kernel_time", 1000.0 * k, d] for k, d in enumerate(median_us)]
    device.append(["memcpy", "Memcpy DtoH (Device -> Pinned)", 9000.0, 500.0])
    return Trace(device=device, host=[], start_us=0.0, end_us=20_000.0)


def test_the_counters_read_per_served_call():
    ctx = _ctx()
    for metric, stage in COUNTERS.items():
        assert reader(metric).read(ctx) == pytest.approx(STAGES[stage] * 1e3 / 2), metric


def test_the_trace_readers_on_a_hand_built_stretch():
    ctx = _ctx(trace=_trace())
    # busy: the medians (the last two overlap: 2 000-8 000 us) and the copy, 6 900 us of 20 000
    assert reader("device_idle_pct.stems").read(ctx) == pytest.approx(100 * (1 - 6_900 / 20_000))
    roof = reader("median31_roofline.stems")
    bytes_ = 0.0
    for s in SECONDS:
        n = s * 44_100
        bytes_ += 2 * (2 * 1025 * (1 + n // 512) * 4) + 2 * (2 * 2 * 2049 * (1 + n // 1024) * 4)
    assert roof.read(ctx) == pytest.approx(100 * bytes_ / 3.35e12 / 7.4e-3)
    assert roof.call_bound_s(ctx.tracks[0]) < roof.call_bound_s(ctx.tracks[1])


@pytest.mark.parametrize("metric", READERS)
def test_a_reader_reads_nothing_where_its_source_is_absent(metric):
    """No counter of that name (the program before these spans has only
    "stems"), no trace, or a trace without the kernel: None, never an
    error."""

    assert reader(metric).read(_ctx(stages={"graph": 0.05})) is None
    if metric.endswith("_roofline.stems"):
        assert reader(metric).read(_ctx(trace=Trace(device=[["kernel", "other", 0.0, 5.0]], end_us=10.0))) is None
