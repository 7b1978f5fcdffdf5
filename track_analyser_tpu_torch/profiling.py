"""Observability: the program's spans and stage counters, per-stage wall
times of the per-module path, and device traces.

``span`` times one host layer where it runs. It always adds its wall time
to a process-wide counter (``stage_seconds()``); while a
``torch.profiler`` session is active anywhere in the process it also
records the span (``spans()``): its name, its parent, the analysis call
and the track it belongs to, its thread, its start and end on the clock
the profiler stamps its events with (``time.time_ns()``), and the CPU
time its thread spent in it. ``analyse_track`` and ``analyse_library``
open one ``call`` span each and a span at every host layer boundary
inside it; the names are the counters' keys. A span's self time is its
duration minus what its children cover.

``StageTimer`` wraps the progress callback of ``analyse_track`` and
records the wall time between its stages, as in the JAX package; only
the per-module path (``fused=False``) reports a stage as it ends. The
fused path is timed by its spans. ``device_trace`` records a
``torch.profiler`` trace (CPU and, where there is a card, CUDA activity:
every kernel and copy with its device time) and writes it as a Chrome
trace, which chrome://tracing or Perfetto opens, with the spans recorded
during its block on their threads' rows.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, Iterator, List, NamedTuple, Optional, Tuple, Union

import torch
import torch.autograd.profiler as _autograd_profiler

__all__ = [
    "StageTimer",
    "device_trace",
    "span",
    "on_track",
    "stamp",
    "close_wait",
    "count_seconds",
    "recording",
    "spans",
    "reset_spans",
    "stage_seconds",
    "reset_stage_seconds",
    "SpanRecord",
]

Track = Union[None, int, Tuple[int, ...]]

# Process-wide seconds per stage, summed over calls, tracks and threads.
_STAGE_SECONDS: Dict[str, float] = {}
_stage_lock = threading.Lock()
# Spans recorded while a profiler session is active (list.append is atomic).
_SPANS: list = []
_span_ids = itertools.count(1)
_local = threading.local()


@dataclass(slots=True)
class SpanRecord:
    """One recorded span. ``call_id`` is the ``span_id`` of the ``call``
    span it descends from (None outside a call); ``track`` the source's
    index in the call, a tuple of indices for a span over a chunk; ``thread``
    the native thread id (None for a wait that spans threads);
    ``start_ns`` / ``end_ns`` on ``time.time_ns()``; ``cpu_ns`` the thread's
    CPU time over the span (None for a wait that spans threads)."""

    name: str
    span_id: int
    parent_id: Optional[int]
    call_id: Optional[int]
    track: Track
    thread: Optional[int]
    start_ns: int
    end_ns: int
    cpu_ns: Optional[int]


class _Frame(NamedTuple):
    span_id: int
    call_id: Optional[int]
    track: Track


def recording() -> bool:
    """Whether spans are recorded: a ``torch.profiler`` session is active
    somewhere in the process (the process-wide flag; the thread-local one
    reads False on threads other than the profiler's)."""

    return _autograd_profiler._is_profiler_enabled


def count_seconds(name: str, seconds: float) -> None:
    """Add ``seconds`` to ``stage_seconds()[name]``."""

    with _stage_lock:
        _STAGE_SECONDS[name] = _STAGE_SECONDS.get(name, 0.0) + seconds


def reset_stage_seconds() -> None:
    with _stage_lock:
        _STAGE_SECONDS.clear()


def stage_seconds() -> Dict[str, float]:
    """Seconds per span name since the last reset, summed over calls,
    tracks and threads (so the sweep's stages overlap): "decode"
    (``coerce_audio``), "decode.wav" (the native one-pass WAV decode,
    inside "decode" or "stems.load"), "resample" (inside "decode"),
    "quantise" (host staging),
    "host_stereo" (inside it), "queue_wait" (a decoded track waiting for
    its chunk's upload, sweep only), "upload" (host time to stage and
    enqueue the copies), "dispatch" (host time to enqueue a graph),
    "finish" (readback, unpack and host finishers; rendering too in the
    sweep), "readback_wait", "finish.beats", "finish.downbeats",
    "finish.structure", "finish.harmony", "finish.rest", "render",
    "stems", "call"; inside "stems" (``analyse_track(use_stems=True)``),
    "stems.load" (the source decoded again, channels kept), "stems.net"
    (the mask net: upload, forward pass, inverses), "stems.dsp" (the DSP
    separator), "stems.blend" (on the device) and "stems.write"
    (quantising on the device, one readback, writing the four WAVs); "graph_capture" and "graph_replay" (inside
    "dispatch" on a card: capturing a CUDA graph, and replaying one with
    its copy-in and readback enqueued); "graph" (the graph on the device
    between two CUDA events, the copy-in and the replay once captured;
    absent on the CPU); and "stems.net_device" (the mask net's upload,
    forward pass and inverses on the device between two CUDA events;
    absent on the CPU)."""

    with _stage_lock:
        return dict(_STAGE_SECONDS)


def spans() -> List[SpanRecord]:
    """The spans recorded since the last ``reset_spans()``, in the order
    they ended."""

    return list(_SPANS)


def reset_spans() -> None:
    _SPANS.clear()


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class span:
    """Time the block as the layer ``name``; a context manager.

    ``track``: the source's index in the call (a tuple of indices for a
    chunk); None inherits the parent's. ``parent``: a ``span`` opened on
    another thread (a task takes its call's ``call`` span); None takes the
    innermost span open on this thread. A span named "call" starts a new
    call. Off the profiler a span costs two clock reads, one flag read and
    one locked counter update."""

    __slots__ = ("name", "track", "parent", "frame", "_parent_id", "_t0", "_start_ns", "_cpu0")

    def __init__(self, name: str, *, track: Track = None, parent: "Optional[span]" = None):
        self.name = name
        self.track = track
        self.parent = parent
        self.frame: Optional[_Frame] = None

    def __enter__(self) -> "span":
        if _autograd_profiler._is_profiler_enabled:
            stack = _stack()
            if self.parent is not None:
                up = self.parent.frame
            else:
                up = stack[-1] if stack else None
            span_id = next(_span_ids)
            call_id = span_id if self.name == "call" else (up.call_id if up else None)
            track = self.track if self.track is not None or up is None else up.track
            self.frame = _Frame(span_id, call_id, track)
            self._parent_id = up.span_id if up else None
            stack.append(self.frame)
            self._start_ns = time.time_ns()
            self._cpu0 = time.thread_time_ns()
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        count_seconds(self.name, (time.perf_counter_ns() - self._t0) / 1e9)
        frame = self.frame
        if frame is not None:
            cpu_ns = time.thread_time_ns() - self._cpu0
            _stack().pop()
            _SPANS.append(SpanRecord(
                self.name, frame.span_id, self._parent_id, frame.call_id, frame.track,
                threading.get_native_id(), self._start_ns, time.time_ns(), cpu_ns,
            ))
            self.frame = None


class on_track:
    """Within the block, spans opened on this thread with no ``track`` of
    their own belong to ``track`` (a lane of a chunk-level span); records
    nothing itself."""

    __slots__ = ("track", "_pushed")

    def __init__(self, track: Track):
        self.track = track
        self._pushed = False

    def __enter__(self) -> "on_track":
        stack = _stack()
        if stack and _autograd_profiler._is_profiler_enabled:
            top = stack[-1]
            stack.append(_Frame(top.span_id, top.call_id, self.track))
            self._pushed = True
        return self

    def __exit__(self, *exc) -> None:
        if self._pushed:
            _stack().pop()
            self._pushed = False


class Stamp(NamedTuple):
    perf_ns: int
    wall_ns: int


def stamp() -> Stamp:
    """Now, on the counters' clock and on the spans' clock: the start of a
    wait that ``close_wait`` ends on another thread."""

    return Stamp(time.perf_counter_ns(), time.time_ns())


def close_wait(name: str, since: Stamp, *, track: Track = None, parent: "Optional[span]" = None) -> None:
    """Count the time from ``since`` to now as ``name`` and, while
    recording, record it as a span on no thread, with no CPU time (a track
    waiting between two threads' layers)."""

    count_seconds(name, (time.perf_counter_ns() - since.perf_ns) / 1e9)
    if _autograd_profiler._is_profiler_enabled:
        up = parent.frame if parent is not None else None
        _SPANS.append(SpanRecord(
            name, next(_span_ids), up.span_id if up else None, up.call_id if up else None, track,
            None, since.wall_ns, time.time_ns(), None,
        ))


@dataclass
class StageTimer:
    """Records wall-clock time between progress-callback stages.

    It times the per-module path (``analyse_track(..., fused=False)``),
    whose stages report as each ends. The fused path (the default) reports
    its stages together at its end; time it with its spans (``span``,
    ``stage_seconds()``, ``spans()``).

    Usage::

        timer = StageTimer()
        analyse_track(path, fused=False, progress_callback=timer.callback(user_cb))
        print(timer.report())
    """

    stages: List[str] = field(default_factory=list)
    durations: Dict[str, float] = field(default_factory=dict)
    _last: float = field(default_factory=time.perf_counter)

    def callback(self, inner: Optional[Callable[[str], None]] = None) -> Callable[[str], None]:
        self._last = time.perf_counter()

        def _cb(stage: str) -> None:
            now = time.perf_counter()
            self.stages.append(stage)
            self.durations[stage] = self.durations.get(stage, 0.0) + (now - self._last)
            self._last = now
            if inner is not None:
                inner(stage)

        return _cb

    @property
    def total(self) -> float:
        return sum(self.durations.values())

    def report(self) -> str:
        lines = [f"{'stage':<12} {'ms':>9} {'share':>7}"]
        total = self.total or 1.0
        for stage in self.stages:
            d = self.durations.get(stage, 0.0)
            lines.append(f"{stage:<12} {d * 1e3:>9.1f} {d / total:>6.1%}")
        lines.append(f"{'total':<12} {total * 1e3:>9.1f}")
        return "\n".join(lines)


def _chrome_events(records: List[SpanRecord], base_ns: int) -> List[dict]:
    """``records`` as Chrome trace events on a time base of ``base_ns``:
    complete events on their threads' rows, a wait that spans threads as
    an async pair."""

    pid = os.getpid()
    events = []
    for r in records:
        args = {"span_id": r.span_id, "parent_id": r.parent_id, "call_id": r.call_id,
                "track": r.track, "cpu_ns": r.cpu_ns}
        ts = (r.start_ns - base_ns) / 1e3
        if r.thread is not None:
            events.append({"ph": "X", "cat": "span", "name": r.name, "pid": pid, "tid": r.thread,
                           "ts": ts, "dur": (r.end_ns - r.start_ns) / 1e3, "args": args})
        else:
            common = {"cat": "span", "name": r.name, "pid": pid, "tid": 0, "id": r.span_id}
            events.append({**common, "ph": "b", "ts": ts, "args": args})
            events.append({**common, "ph": "e", "ts": (r.end_ns - base_ns) / 1e3})
    return events


@contextlib.contextmanager
def device_trace(log_dir: "str | Path") -> Iterator[Path]:
    """Record a ``torch.profiler`` trace of the block and write it to
    ``log_dir/trace_<pid>_<ns>.json`` (Chrome trace format) when the block
    ends; yields that path. The CUDA activity is recorded where a card is
    present, the CPU's always; the program's spans recorded during the
    block are written into it on the profiler's time base."""

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    out = Path(log_dir) / f"trace_{os.getpid()}_{time.time_ns()}.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.time_ns()
    with torch.profiler.profile(activities=activities) as prof:
        yield out
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    t1 = time.time_ns()
    prof.export_chrome_trace(str(out))
    mine = [r for r in spans() if r.start_ns >= t0 and r.end_ns <= t1]
    if mine:
        data = json.loads(out.read_text())
        data["traceEvents"].extend(_chrome_events(mine, int(data.get("baseTimeNanoseconds", 0))))
        out.write_text(json.dumps(data))
