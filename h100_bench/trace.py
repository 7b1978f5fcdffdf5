"""A traced stretch of a run: the card's operations and the host's, read
from ``torch.profiler`` (CUPTI), reduced to what the readers need.

``Trace`` holds the device intervals (kernels, copies, memsets) and the
host operations of one stretch, in microseconds on the profiler's clock,
and the stretch's own bounds, taken from a marker around it. It can be
written to and read from JSON, so the readers are tested on a recorded
trace.
"""

from __future__ import annotations

import contextlib
import threading
import time
from dataclasses import dataclass, field
from typing import Iterator, List, Tuple

MARK = "h100_bench.stretch"
# Host ranges of the program's layers, recorded in the traced stretch
# only (by wrapping these names), so that an idle gap of the card can be
# named by the layer the host was in: (module, attribute, label).
LAYER_SPANS = (
    ("track_analyser_tpu_torch.pipeline", "coerce_audio", "host decode (coerce_audio)"),
    ("track_analyser_tpu_torch.parallel.batch", "coerce_audio", "host decode (coerce_audio)"),
    ("track_analyser_tpu_torch.parallel.batch", "_stage_track", "host staging (_stage_track)"),
    ("track_analyser_tpu_torch.parallel.batch", "_upload", "upload (_upload)"),
    ("track_analyser_tpu_torch.parallel.batch", "_dispatch", "graph enqueue (_dispatch)"),
    ("track_analyser_tpu_torch.parallel.batch", "_fetch", "readback wait (_fetch)"),
    ("track_analyser_tpu_torch.parallel.batch", "result_from_graph_outputs", "host finishers (result_from_graph_outputs)"),
)
_DEVICE_KINDS = {"kernel": "kernel", "gpu_memcpy": "memcpy", "gpu_memset": "memset"}


@dataclass
class Trace:
    """``device``: [kind, name, start_us, dur_us]; ``host``: [name,
    start_us, dur_us, thread]; ``start_us`` / ``end_us``: the stretch."""

    device: List[list] = field(default_factory=list)
    host: List[list] = field(default_factory=list)
    start_us: float = 0.0
    end_us: float = 0.0

    @property
    def window_s(self) -> float:
        return (self.end_us - self.start_us) / 1e6

    def busy_intervals(self) -> List[Tuple[float, float]]:
        """The union of device intervals inside the stretch, sorted."""

        spans = sorted(
            (max(s, self.start_us), min(s + d, self.end_us))
            for _k, _n, s, d in self.device
            if s + d > self.start_us and s < self.end_us
        )
        merged: List[list] = []
        for s, e in spans:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e6

    def device_time_s(self, names: "Tuple[str, ...]") -> Tuple[float, int]:
        """(seconds, launches) of the device operations whose name contains
        any of ``names``."""

        hits = [d for _k, n, _s, d in self.device if any(x in n for x in names)]
        return sum(hits) / 1e6, len(hits)

    def top_device_ops(self, k: int = 10) -> List[list]:
        totals: dict = {}
        for _kind, name, _s, d in self.device:
            totals[name] = totals.get(name, 0.0) + d
        return [[n[:160], t / 1e6] for n, t in sorted(totals.items(), key=lambda kv: -kv[1])[:k]]

    def idle_gaps(self, k: int = 10) -> List[list]:
        """The ``k`` longest idle gaps of the card inside the stretch, each
        named by the host range that overlaps it most: a layer of the
        program where one does, else any host operation the profiler
        recorded (CUDA runtime calls included)."""

        edges = [self.start_us]
        for s, e in self.busy_intervals():
            edges += [s, e]
        edges.append(self.end_us)
        gaps = sorted(((edges[i + 1] - edges[i], edges[i]) for i in range(0, len(edges), 2)), reverse=True)[:k]
        layers = {label for _m, _a, label in LAYER_SPANS}
        out = []
        for length, start in gaps:
            end = start + length
            best, label = 0.0, "host outside any recorded range"
            for prefer in (True, False):
                for name, s, d, _thread in self.host:
                    if name == MARK or (name in layers) != prefer:
                        continue
                    overlap = min(end, s + d) - max(start, s)
                    if overlap > best:
                        best, label = overlap, name
                if best > 0:
                    break
            out.append([label[:160], length / 1e6])
        return out

    def to_json(self) -> dict:
        return {"device": self.device, "host": self.host, "start_us": self.start_us, "end_us": self.end_us}

    @classmethod
    def from_json(cls, data: dict) -> "Trace":
        return cls(data["device"], data["host"], data["start_us"], data["end_us"])


def _kind(e) -> str:
    """The event's activity: "kernel", "memcpy", "memset", "annotation"
    (a host range mirrored on the card) or "host". Read from
    ``activity_type`` where the profiler has it, else from the device and
    the name."""

    activity = getattr(e, "activity_type", None)
    if activity is not None:
        a = activity()
        if a in _DEVICE_KINDS:
            return _DEVICE_KINDS[a]
        return "annotation" if a == "gpu_user_annotation" else "host"
    if str(e.device_type()).endswith("CPU"):
        return "host"
    name = e.name()
    if name.startswith("Memcpy"):
        return "memcpy"
    if name.startswith("Memset"):
        return "memset"
    return "kernel"


def _reduce(events) -> Trace:
    trace = Trace()
    device = []
    for e in events:
        kind = _kind(e)
        if kind == "host":
            trace.host.append([e.name(), e.start_ns() / 1e3, e.duration_ns() / 1e3, e.start_thread_id()])
            if e.name() == MARK:
                trace.start_us, trace.end_us = e.start_ns() / 1e3, e.end_ns() / 1e3
        elif kind != "annotation":
            device.append([kind, e.name(), e.start_ns() / 1e3, e.duration_ns() / 1e3])
    # Host ranges (record_function) are mirrored on the card's timeline
    # under their own names; they are not work of the card.
    host_names = {h[0] for h in trace.host}
    trace.device = [d for d in device if d[1] not in host_names]
    return trace


@contextlib.contextmanager
def _layer_spans(spans: list) -> Iterator[None]:
    """Wrap each of ``LAYER_SPANS`` for the block so that every call
    appends [label, start_us, dur_us, thread] to ``spans``, on the wall
    clock the profiler stamps its events with; a name the program no
    longer has is skipped. (The profiler records host operations of the
    thread that started it only; the sweep's layers run on its pools.)"""

    import importlib

    undo = []
    for module_name, attr, label in LAYER_SPANS:
        module = importlib.import_module(module_name)
        fn = getattr(module, attr, None)
        if fn is None:
            continue

        def wrapped(*args, _fn=fn, _label=label, **kwargs):
            t0 = time.time_ns()
            try:
                return _fn(*args, **kwargs)
            finally:
                spans.append([_label, t0 / 1e3, (time.time_ns() - t0) / 1e3, threading.get_ident()])

        setattr(module, attr, wrapped)
        undo.append((module, attr, fn))
    try:
        yield
    finally:
        for module, attr, fn in reversed(undo):
            setattr(module, attr, fn)


@contextlib.contextmanager
def stretch() -> Iterator[list]:
    """Profile the block (CPU and CUDA activity, the program's layers
    recorded as host ranges); yields a list that holds the reduced
    ``Trace`` once the block has ended."""

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    holder: list = []
    spans: list = []
    on_card = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    with _layer_spans(spans), profile(activities=activities) as prof:
        with record_function(MARK):
            yield holder
            if on_card:
                torch.cuda.synchronize()
    trace = _reduce(prof.profiler.kineto_results.events())
    trace.host.extend(spans)
    holder.append(trace)
