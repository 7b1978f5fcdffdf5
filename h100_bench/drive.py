"""The general traffic generator: a traffic file's parameters drive the
program's entry points over a corpus.

Kinds:

- ``single``: one client in a closed loop, ``analyse_track(path)`` on the
  corpus in seeded cycles (each cycle a fresh seeded permutation), the
  next call sent when the last returns.
- ``sweep``: ``analyse_library(paths)`` calls back to back, each over
  ``rotations`` seeded permutations of the corpus.

The configuration's ``call`` and the traffic's ``call`` are keyword
arguments of the entry point (``output_dir: true`` becomes a fresh
directory of the run). Each call runs in a fresh directory of its own
under the run's ``calls/`` (its outcomes' ``run_dir``), so what it writes
relative to the working directory lands there, is judged as that call's
own after the window, and goes with the run; the warm-up's are removed
when it ends. The window starts calls while it is open and closes when
the last one returns, so every call in it is whole.
"""

from __future__ import annotations

import contextlib
import itertools
import shutil
import time
import traceback
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Iterator, List, Optional

import numpy as np

from .gen.corpus import Track


@dataclass
class Outcome:
    """One served track: its corpus index, the result (decoded audio
    dropped) or the error, for a single call its latency, and the
    directory its call ran in."""

    track: int
    result: object = None
    error: Optional[str] = None
    latency_s: Optional[float] = None
    run_dir: Optional[Path] = None


@dataclass
class Window:
    seconds: float = 0.0
    calls: int = 0
    outcomes: List[Outcome] = field(default_factory=list)


def _strip(result) -> object:
    result.audio = None
    return result


class Driver:
    """Serves one traffic mix over ``tracks`` on ``device``."""

    def __init__(self, traffic: dict, config: dict, tracks: List[Track], seed: int, device: str, work_dir: Path):
        self.kind = traffic["kind"]
        if self.kind not in ("single", "sweep"):
            raise ValueError(f"unknown traffic kind {self.kind!r}")
        self.tracks = tracks
        self.rotations = int(traffic.get("rotations", 1))
        self.kwargs = {**config.get("call", {}), **traffic.get("call", {}), "device": device}
        if self.kwargs.get("output_dir") is True:
            self.kwargs["output_dir"] = str(work_dir / "out")
        self.calls_dir = Path(work_dir) / "calls"
        self.calls_dir.mkdir()
        self._made = 0
        self._rng = np.random.default_rng([int(seed), 1])
        self._order = self._cycles()

    def _cycles(self) -> Iterator[int]:
        while True:
            yield from (int(i) for i in self._rng.permutation(len(self.tracks)))

    def _sweep_sources(self) -> List[int]:
        return list(itertools.islice(self._order, self.rotations * len(self.tracks)))

    @contextlib.contextmanager
    def _own_dir(self) -> Iterator[Path]:
        """A fresh directory under ``calls_dir``, the working directory
        while one call runs; the one before is restored afterwards."""

        run_dir = self.calls_dir / str(self._made)
        self._made += 1
        run_dir.mkdir()
        with contextlib.chdir(run_dir):
            yield run_dir

    # -- one call of each kind -------------------------------------------
    def _single(self, index: int) -> Outcome:
        from track_analyser_tpu_torch.pipeline import analyse_track

        with self._own_dir() as run_dir:
            t0 = time.perf_counter()
            try:
                result = analyse_track(self.tracks[index].path, **self.kwargs)
            except Exception:  # a failed call is counted, not fatal to the run
                return Outcome(index, error=traceback.format_exc(limit=3), latency_s=time.perf_counter() - t0,
                               run_dir=run_dir)
            return Outcome(index, _strip(result), latency_s=time.perf_counter() - t0, run_dir=run_dir)

    def _sweep(self, indices: List[int]) -> List[Outcome]:
        from track_analyser_tpu_torch.parallel.batch import TrackFailure, analyse_library

        with self._own_dir() as run_dir:
            try:
                results = analyse_library([self.tracks[i].path for i in indices], **self.kwargs)
            except Exception:  # the whole call failed: every source of it failed
                err = traceback.format_exc(limit=3)
                return [Outcome(i, error=err, run_dir=run_dir) for i in indices]
        out = []
        for i, r in zip(indices, results):
            if isinstance(r, TrackFailure) or not hasattr(r, "beat"):
                out.append(Outcome(i, error=str(getattr(r, "error", r)), run_dir=run_dir))
            else:
                out.append(Outcome(i, _strip(r), run_dir=run_dir))
        return out

    # -- warm-up, window, traced stretch ----------------------------------
    def warm(self, bucket_of: Callable[[Track], int]) -> List[Outcome]:
        """One call per distinct bucket of the corpus (a one-file sweep per
        bucket for ``sweep``); what they wrote is removed."""

        firsts = {}
        for t in self.tracks:
            firsts.setdefault(bucket_of(t), t.index)
        if self.kind == "single":
            out = [self._single(i) for i in firsts.values()]
        else:
            out = self._sweep(list(firsts.values()))
        for run_dir in {o.run_dir for o in out}:
            shutil.rmtree(run_dir)
        return out

    def window(self, seconds: float) -> Window:
        w = Window()
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            if self.kind == "single":
                w.outcomes.append(self._single(next(self._order)))
            else:
                w.outcomes.extend(self._sweep(self._sweep_sources()))
            w.calls += 1
        w.seconds = time.perf_counter() - t0
        return w

    def stretch(self) -> List[Outcome]:
        """The traced stretch: one cycle of the corpus (``single``) or one
        call (``sweep``) of the same traffic."""

        if self.kind == "single":
            return [self._single(next(self._order)) for _ in range(len(self.tracks))]
        return self._sweep(self._sweep_sources())
