"""The port's spans (``profiling.span``) on the CPU.

- Off the profiler nothing is recorded, and ``stage_seconds()`` counts
  every host layer of ``analyse_track``.
- Under ``torch.profiler`` an ``analyse_library`` of three 22.05 kHz clips
  records its layers on the pool threads, each per-track span tagged with
  its source's index, every parent chain ending at the call's ``call``
  span, children inside their parents.
- A span lies on the profiler's clock: it encloses the op it wraps, and
  ``device_trace`` writes it into its Chrome trace around that op.
- The single path's ``call`` is covered by its direct children.
- The switch: the process-wide profiler flag is visible on a pool thread.
- ``h100_bench.trace.LAYER_SPANS`` names functions the port has.
"""

from __future__ import annotations

import importlib
import json
import threading
from concurrent.futures import ThreadPoolExecutor

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from chip_smoke import make_track, with_noise_floor
from h100_bench.trace import LAYER_SPANS
from track_analyser_tpu_torch import analyse_track, profiling
from track_analyser_tpu_torch.io import write_wav
from track_analyser_tpu_torch.parallel import batch as tb

torch.set_num_threads(2)

SR = 22_050
# Layers of every track, and of every chunk (upload, dispatch, finish).
PER_TRACK = {"decode", "resample", "quantise", "host_stereo", "queue_wait", "finish.beats",
             "finish.downbeats", "finish.structure", "finish.harmony", "finish.rest"}
PER_CHUNK = {"upload", "dispatch", "finish"}
SINGLE = ("decode", "quantise", "upload", "dispatch", "finish")


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    root = tmp_path_factory.mktemp("clips")
    paths = []
    for i, (seconds, bpm) in enumerate(((3.0, 120.0), (2.6, 126.0), (2.8, 118.0))):
        x = with_noise_floor(make_track(seconds, sr=SR, bpm=bpm, seed=i), 200 + i)
        path = root / f"clip{i}.wav"
        write_wav(path, x.mean(axis=0), SR)
        paths.append(str(path))
    return paths


def _profiled(fn):
    profiling.reset_spans()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, profiling.spans(), prof


@pytest.fixture(scope="module")
def sweep_spans(clips):
    results, records, _prof = _profiled(lambda: tb.analyse_library(clips, device="cpu"))
    assert all(hasattr(r, "beat") for r in results)
    return records


def test_off_the_profiler_it_counts_and_records_nothing(clips) -> None:
    profiling.reset_spans()
    tb.reset_stage_seconds()
    analyse_track(clips[0], device="cpu")
    assert profiling.spans() == []
    stages = tb.stage_seconds()
    assert stages == profiling.stage_seconds()
    assert all(stages.get(k, 0.0) > 0 for k in SINGLE + ("resample", "host_stereo", "call")), stages


def test_the_sweep_records_its_layers_on_the_pool_threads(clips, sweep_spans) -> None:
    names = {r.name for r in sweep_spans}
    assert PER_TRACK | PER_CHUNK | {"call"} <= names, names
    calls = [r for r in sweep_spans if r.name == "call"]
    assert len(calls) == 1 and calls[0].thread == threading.get_native_id()
    assert {r.thread for r in sweep_spans if r.name != "queue_wait"} - {calls[0].thread}, "no pool thread"
    for name in PER_TRACK:
        tracks = sorted(r.track for r in sweep_spans if r.name == name)
        assert tracks == [0, 1, 2], (name, tracks)
    for name in PER_CHUNK:
        chunks = [r.track for r in sweep_spans if r.name == name]
        assert sorted(i for t in chunks for i in t) == [0, 1, 2], (name, chunks)
    waits = [r for r in sweep_spans if r.name == "queue_wait"]
    assert all(r.thread is None and r.cpu_ns is None for r in waits)
    assert all(r.cpu_ns >= 0 for r in sweep_spans if r.thread is not None)


def test_parents_chain_to_the_call_and_enclose_their_children(sweep_spans) -> None:
    by_id = {r.span_id: r for r in sweep_spans}
    (call,) = [r for r in sweep_spans if r.name == "call"]
    for r in sweep_spans:
        assert r.call_id == call.span_id, r
        assert r.start_ns <= r.end_ns
        node = r
        while node.parent_id is not None:
            parent = by_id[node.parent_id]
            assert parent.start_ns <= node.start_ns and node.end_ns <= parent.end_ns, (node, parent)
            node = parent
        assert node is call, r
    inner = {"resample": "decode", "host_stereo": "quantise", "finish.rest": "finish"}
    for child, parent in inner.items():
        assert all(by_id[r.parent_id].name == parent for r in sweep_spans if r.name == child), child


def test_a_span_lies_on_the_profilers_clock() -> None:
    x = torch.randn(128, 128)
    profiling.reset_spans()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("clock"):
            x @ x
    (rec,) = [r for r in profiling.spans() if r.name == "clock"]
    mm = [e for e in prof.profiler.kineto_results.events() if e.name() == "aten::mm"]
    assert mm and all(rec.start_ns <= e.start_ns() and e.end_ns() <= rec.end_ns for e in mm)


def test_device_trace_writes_the_spans_around_their_ops(tmp_path) -> None:
    x = torch.randn(128, 128)
    with profiling.device_trace(tmp_path) as path:
        with profiling.span("around_mm"):
            x @ x
    events = json.loads(path.read_text())["traceEvents"]
    (mine,) = [e for e in events if e.get("name") == "around_mm"]
    assert mine["ph"] == "X" and mine["cat"] == "span" and mine["tid"] == threading.get_native_id()
    mm = [e for e in events if e.get("name") == "aten::mm"]
    assert mm and all(
        mine["ts"] <= e["ts"] and e["ts"] + e["dur"] <= mine["ts"] + mine["dur"] for e in mm
    )


def test_the_single_path_call_is_covered_by_its_children(clips) -> None:
    _result, records, _prof = _profiled(lambda: analyse_track(clips[1], device="cpu"))
    (call,) = [r for r in records if r.name == "call"]
    children = sorted((r.start_ns, r.end_ns) for r in records if r.parent_id == call.span_id)
    assert [r.name for r in sorted(records, key=lambda r: r.start_ns) if r.parent_id == call.span_id] == list(SINGLE)
    assert all(r.track == 0 and r.call_id == call.span_id for r in records)
    covered, reach = 0, call.start_ns
    for s, e in children:
        covered += max(0, e - max(s, reach))
        reach = max(reach, e)
    assert covered >= 0.9 * (call.end_ns - call.start_ns), (covered, call.end_ns - call.start_ns)


def test_the_native_wav_pass_nests_in_decode(clips, sweep_spans) -> None:
    """One "decode.wav" span inside each "decode": on the single path, and
    on the sweep's pool threads, tagged with the decode's track."""

    _result, records, _prof = _profiled(lambda: analyse_track(clips[2], device="cpu"))
    for spans in (records, sweep_spans):
        by_id = {r.span_id: r for r in spans}
        passes = [r for r in spans if r.name == "decode.wav"]
        decodes = [r for r in spans if r.name == "decode"]
        assert sorted(r.parent_id for r in passes) == sorted(r.span_id for r in decodes)
        for r in passes:
            parent = by_id[r.parent_id]
            assert r.track == parent.track and r.thread == parent.thread
            assert parent.start_ns <= r.start_ns and r.end_ns <= parent.end_ns


def test_the_profiler_flag_is_visible_on_a_pool_thread() -> None:
    with ThreadPoolExecutor(max_workers=1) as pool:
        assert pool.submit(profiling.recording).result() is False
        with profile(activities=[ProfilerActivity.CPU]):
            assert pool.submit(profiling.recording).result() is True
        assert pool.submit(profiling.recording).result() is False


@pytest.mark.parametrize("module, attr, label", LAYER_SPANS, ids=[f"{m}.{a}" for m, a, _ in LAYER_SPANS])
def test_the_benchmarks_wrapped_layers_exist(module, attr, label) -> None:
    assert callable(getattr(importlib.import_module(module), attr)), label


def test_threads_record_every_span_once() -> None:
    def work(_i):
        for _ in range(200):
            with profiling.span("stress"):
                pass
        return list(profiling._stack())

    profiling.reset_spans()
    with profile(activities=[ProfilerActivity.CPU]), ThreadPoolExecutor(max_workers=8) as pool:
        stacks = list(pool.map(work, range(16)))
    records = [r for r in profiling.spans() if r.name == "stress"]
    assert len(records) == 16 * 200 and len({r.span_id for r in records}) == len(records)
    assert stacks == [[]] * 16 and all(r.parent_id is None for r in records)


def test_self_time_is_the_wall_less_what_children_cover() -> None:
    from track_analyser_tpu_torch.profile_track import self_times_ms

    def rec(name, span_id, parent_id, start, end):
        return profiling.SpanRecord(name, span_id, parent_id, 1, 0, 1, start * 10**6, end * 10**6, 0)

    records = [rec("call", 1, None, 0, 100), rec("decode", 2, 1, 10, 40), rec("queue_wait", 3, 1, 30, 60),
               rec("resample", 4, 2, 20, 30), rec("finish", 5, 1, 90, 120)]
    assert self_times_ms(records) == {"call": 100 - 50 - 10, "decode": 20, "queue_wait": 30,
                                      "resample": 10, "finish": 30}
