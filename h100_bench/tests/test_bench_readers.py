"""The metric readers and the trace reduction, on a hand-built trace with
known answers and on a trace recorded on the H100 (a slice of the
`sweep-cd44k` traced stretch, kept in ``data/``)."""

import importlib.util
import json
from pathlib import Path
from types import SimpleNamespace

import pytest

from h100_bench import roofline
from h100_bench.drive import Outcome, Window
from h100_bench.gen.corpus import Track
from h100_bench.harness import Context
from h100_bench.trace import MARK, Trace

BENCH = Path(__file__).resolve().parents[1]
RECORDED = Path(__file__).resolve().parent / "data" / "trace_sweep_cd44k.json"


def reader(name):
    spec = importlib.util.spec_from_file_location(name, BENCH / "metrics" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def _track(i, seconds=181):
    return Track(i, f"t{i}.wav", "club", seconds, 44_100, 2, seconds * 44_100)


def _ctx(trace=None, outcomes=(), stretch=(), stages=None, seconds=10.0, calls=1):
    tracks = [_track(i) for i in range(4)]
    return Context("x", 1.0, Window(seconds, calls, list(outcomes)), tracks, stages or {}, trace, list(stretch))


def test_busy_union_and_gaps_by_hand():
    t = Trace(
        device=[["kernel", "a", 10.0, 10.0], ["memcpy", "Memcpy HtoD", 15.0, 10.0], ["kernel", "median31_kernel_time", 60.0, 20.0]],
        host=[[MARK, 0.0, 100.0, 1], ["aten::stft", 20.0, 45.0, 1], ["aten::stack", 30.0, 10.0, 2]],
        start_us=0.0, end_us=100.0,
    )
    assert t.busy_intervals() == [(10.0, 25.0), (60.0, 80.0)]
    t.host.append(["host finishers (result_from_graph_outputs)", 95.0, 5.0, 2])  # a layer beats a larger op
    t.host.append(["cudaStreamSynchronize", 80.0, 20.0, 1])
    assert t.busy_s() == pytest.approx(35e-6)
    # gaps: [25, 60) mostly under aten::stft, [80, 100) touched by a layer, [0, 10) under nothing
    assert t.idle_gaps() == [["aten::stft", 35e-6], ["host finishers (result_from_graph_outputs)", 20e-6], ["host outside any recorded range", 10e-6]]
    assert reader("device_idle_pct.sweep")(_ctx(t)) == pytest.approx(65.0)
    assert t.device_time_s(("median31_kernel",)) == (pytest.approx(20e-6), 1)
    assert Trace.from_json(json.loads(json.dumps(t.to_json()))).busy_intervals() == t.busy_intervals()


def test_readers_find_nothing_where_there_is_nothing():
    ctx = _ctx()
    for name in ("device_idle_pct.single", "device_idle_pct.sweep", "median31_roofline.sweep",
                 "graph_ms.single", "dispatch_ms.sweep", "track_ms", "track_ms_p90", "audio_s_per_s.sweep",
                 "device_memory_peak_mib"):
        assert reader(name)(ctx) is None, name


def test_host_clock_metrics():
    single = _ctx(outcomes=[Outcome(0, object(), latency_s=0.2), Outcome(1, object(), latency_s=0.4)], seconds=0.6, calls=2)
    assert reader("track_ms")(single) == pytest.approx(300.0)
    assert reader("track_ms_p90")(single) == pytest.approx(380.0)
    sweep = _ctx(outcomes=[Outcome(0, object()), Outcome(1, object()), Outcome(2, error="x")], seconds=2.0,
                 stages={"dispatch": 0.3, "graph": 0.05})
    assert reader("audio_s_per_s.sweep")(sweep) == pytest.approx(181.0)
    assert reader("dispatch_ms.sweep")(sweep) == pytest.approx(150.0)
    assert reader("graph_ms.sweep")(sweep) == pytest.approx(25.0)
    sweep.memory_peak_bytes = 3 * 2**20
    assert reader("device_memory_peak_mib")(sweep) == pytest.approx(3.0)


def test_readers_on_a_recorded_trace():
    data = json.loads(RECORDED.read_text())
    t = Trace.from_json(data["trace"])
    assert 0 < t.busy_s() < t.window_s
    ops = t.top_device_ops()
    assert ops == sorted(ops, key=lambda o: -o[1]) and len(ops) <= 10
    gaps = t.idle_gaps()
    assert [g[1] for g in gaps] == sorted((g[1] for g in gaps), reverse=True)
    assert sum(g[1] for g in gaps) <= t.window_s - t.busy_s() + 1e-9
    stretch = [Outcome(i, object()) for i in range(data["tracks"])]
    ctx = _ctx(t, stretch=stretch)
    ctx.tracks = [_track(i, s) for i, s in enumerate(data["seconds"])]
    share = reader("median31_roofline.sweep")(ctx)
    seconds, launches = t.device_time_s(("median31_kernel",))
    assert launches == 2 * data["tracks"]
    bound = sum(2 * roofline.median31_bound_s(roofline.hpss_frames(s * 44_100)) for s in data["seconds"])
    assert share == pytest.approx(100 * bound / seconds) and 0 < share <= 100
    assert 0 < reader("device_idle_pct.sweep")(ctx) < 100
