"""The readers of the program's spans and counters, on traced stretches
recorded on the H100 (``data/spans_fixture.json``): one
``analyse_track`` call of a 30 s stereo track and one ``analyse_library``
call of two 10 s mono clips at 22.05 kHz, each with the device intervals,
the program's spans and its stage counters over the stretch. The idle
shares are held against a count on a 0.1 us grid."""

import importlib.util
import json
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from h100_bench import spans as span_reading
from h100_bench.drive import Outcome, Window
from h100_bench.gen.corpus import Track
from h100_bench.harness import Context
from h100_bench.trace import Trace

BENCH = Path(__file__).resolve().parents[1]
FIXTURE = Path(__file__).resolve().parent / "data" / "spans_fixture.json"
# The counters the program had before its spans, by path.
PARENT_STAGES = {"single": {"graph"}, "sweep": {"decode", "quantise", "upload", "dispatch", "finish", "graph"}}
COUNTERS = {
    "single": {"decode_ms.single": "decode", "quantise_ms.single": "quantise",
               "dispatch_ms.single": "dispatch", "finish_ms.single": "finish"},
    "sweep": {"resample_ms.sweep": "resample", "host_stereo_ms.sweep": "host_stereo",
              "queue_wait_ms.sweep": "queue_wait"},
}


def reader(name):
    spec = importlib.util.spec_from_file_location(name, BENCH / "metrics" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


@pytest.fixture(scope="module")
def recorded():
    return json.loads(FIXTURE.read_text())


def _ctx(monkeypatch, part, records=None):
    """The part's stretch as a run's context, its spans as the program's."""

    served = part["served"]
    latency = 0.1 if served == 1 else None
    outcomes = [Outcome(i, object(), latency_s=latency) for i in range(served)]
    tracks = [Track(i, f"t{i}.wav", "club", 30, 44_100, 2, 30 * 44_100) for i in range(served)]
    ctx = Context("x", 1.0, Window(1.0, 1, outcomes), tracks, dict(part["stages"]),
                  Trace.from_json(part["trace"]), outcomes)
    if records is None:
        records = [SimpleNamespace(**r) for r in part["spans"]]
    monkeypatch.setattr(span_reading, "recorded", lambda: records)
    return ctx


def _idle_on_a_grid(part, name, step_us=0.1):
    t = part["trace"]
    start, end = t["start_us"], t["end_us"]
    n = int(np.ceil((end - start) / step_us))

    def mask(intervals):
        m = np.zeros(n, dtype=bool)
        for s, e in intervals:
            a, b = int(round((max(s, start) - start) / step_us)), int(round((min(e, end) - start) / step_us))
            m[a:max(a, b)] = True
        return m

    busy = mask((s, s + d) for _k, _n, s, d in t["device"])
    mine = mask((r["start_ns"] / 1e3, r["end_ns"] / 1e3) for r in part["spans"] if r["name"] == name)
    edges = 2 * (len(t["device"]) + len(part["spans"]))
    return 100.0 * (mine & ~busy).sum() / n, 100.0 * edges / n


@pytest.mark.parametrize("kind", ["single", "sweep"])
def test_counter_readers_read_the_stage_counters(monkeypatch, recorded, kind):
    part = recorded[kind]
    ctx = _ctx(monkeypatch, part)
    for metric, stage in COUNTERS[kind].items():
        value = reader(metric)(ctx)
        assert value == pytest.approx(part["stages"][stage] * 1e3 / part["served"]) and value > 0, metric


@pytest.mark.parametrize("kind, metric, name", [("single", "idle_in_decode_pct.single", "decode"),
                                                ("sweep", "idle_in_dispatch_pct.sweep", "dispatch")])
def test_idle_in_a_layer_against_a_grid(monkeypatch, recorded, kind, metric, name):
    part = recorded[kind]
    ctx = _ctx(monkeypatch, part)
    value = reader(metric)(ctx)
    expected, slack = _idle_on_a_grid(part, name)
    assert value == pytest.approx(expected, abs=slack)
    assert 0 < value <= reader(f"device_idle_pct.{kind}")(ctx) + 1e-9


def test_dispatch_blocked_is_the_enqueues_time_off_the_cpu(monkeypatch, recorded):
    part = recorded["sweep"]
    ctx = _ctx(monkeypatch, part)
    dispatch = [r for r in part["spans"] if r["name"] == "dispatch"]
    wall = sum(r["end_ns"] - r["start_ns"] for r in dispatch) / 1e6 / part["served"]
    value = reader("dispatch_blocked_ms.sweep")(ctx)
    assert 0 <= value <= wall
    assert value == pytest.approx(wall - sum(r["cpu_ns"] for r in dispatch) / 1e6 / part["served"])


def test_spans_outside_the_stretch_are_not_read(monkeypatch, recorded):
    part = recorded["single"]
    late = part["trace"]["end_us"] * 1e3 + 1e6
    outside = [SimpleNamespace(**{**r, "start_ns": late, "end_ns": late + 1e3}) for r in part["spans"]]
    assert reader("idle_in_decode_pct.single")(_ctx(monkeypatch, part, outside)) is None


@pytest.mark.parametrize("metric", ["idle_in_decode_pct.single", "idle_in_dispatch_pct.sweep",
                                    "dispatch_blocked_ms.sweep", "decode_ms.single", "resample_ms.sweep"])
def test_a_program_without_spans_reads_nothing(monkeypatch, recorded, metric):
    """The parent of the spans has no ``profiling.spans`` and no such
    counters: every new reader returns None, and none raises."""

    kind = "single" if metric.endswith("single") else "sweep"
    ctx = _ctx(monkeypatch, recorded[kind])
    monkeypatch.setattr(span_reading, "recorded", lambda: None)
    ctx.stages = {k: v for k, v in ctx.stages.items() if k in PARENT_STAGES[kind]}
    assert reader(metric)(ctx) is None


def test_recorded_is_none_where_the_program_has_no_spans(monkeypatch):
    from track_analyser_tpu_torch import profiling

    assert span_reading.recorded() == profiling.spans()
    monkeypatch.delattr(profiling, "spans")
    assert span_reading.recorded() is None
