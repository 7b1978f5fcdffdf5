"""Observability: per-stage wall times and device traces.

``StageTimer`` wraps the progress callback of ``analyse_track`` and
records the wall time between its stages, as in the JAX package.
``device_trace`` records a ``torch.profiler`` trace (CPU and, where
there is a card, CUDA activity: every kernel and copy with its device
time) and writes it as a Chrome trace, which chrome://tracing or
Perfetto opens.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, Iterator, List, Optional

import torch

__all__ = ["StageTimer", "device_trace"]


@dataclass
class StageTimer:
    """Records wall-clock time between progress-callback stages.

    Usage::

        timer = StageTimer()
        analyse_track(path, progress_callback=timer.callback(user_cb))
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


@contextlib.contextmanager
def device_trace(log_dir: "str | Path") -> Iterator[Path]:
    """Record a ``torch.profiler`` trace of the block and write it to
    ``log_dir/trace_<pid>_<ns>.json`` (Chrome trace format) when the block
    ends; yields that path. The CUDA activity is recorded where a card is
    present, the CPU's always."""

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    out = Path(log_dir) / f"trace_{os.getpid()}_{time.time_ns()}.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield out
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(out))
