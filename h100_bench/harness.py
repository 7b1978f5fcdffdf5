"""One run of one cell: set-up, the measured window, the traced stretch,
and the comparison with the plain reference.

``run_cell`` is the whole run minus the command line and the look for a
chip, so the CPU tests drive it at a tiny size; ``run.py`` wraps it.
"""

from __future__ import annotations

import json
import shutil
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence

from . import correct, roofline
from .drive import Driver, Outcome, Window
from .gen import corpus
from .spec import Cell, Spec, read_metrics
from .trace import Trace, stretch

# Whole top-level module names that must not be loaded in a run.
FORBIDDEN = ("jax", "jaxlib", "flax", "track_analyser_tpu")


@dataclass
class Context:
    """What the metric readers read."""

    cell: str
    setup_s: float
    window: Window
    tracks: List[corpus.Track]
    stages: Dict[str, float] = field(default_factory=dict)
    trace: Optional[Trace] = None
    stretch_outcomes: List[Outcome] = field(default_factory=list)
    memory_peak_bytes: int = 0

    @property
    def done(self) -> List[Outcome]:
        return [o for o in self.window.outcomes if o.error is None]

    def audio_seconds(self, outcomes: List[Outcome]) -> float:
        return sum(self.tracks[o.track].frames / self.tracks[o.track].sample_rate for o in outcomes)


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def bucket_of(track: corpus.Track) -> int:
    """The padded length the track is analysed at: tracks that share it
    share the program's compiled shapes, so warm-up makes one call each."""

    from .reference.audio import bucket_length

    return bucket_length(roofline.analysis_samples(track.frames, track.sample_rate))


def _reference(tracks: List[corpus.Track], indices, device: str, tf32: bool,
               references: Sequence[correct.Reference] = (correct.ANALYSIS,)) -> dict:
    """{corpus index: {reference: answer}} for each index in ``indices``
    (once a file); ``tf32`` computes each in the precision control's
    float32 with TF32."""

    return {i: {r.name: r.analyse(tracks[i].path, device=device, control=tf32) for r in references}
            for i in sorted(set(indices))}


def compare(outcomes: List[Outcome], refs: dict, tracks: List[corpus.Track],
            references: Sequence[correct.Reference] = (correct.ANALYSIS,),
            answers: Optional[dict] = None) -> correct.Numbers:
    """Every reference's leaves of each outcome against its answer in
    ``refs``. The leaves are read from what the outcome served, its result
    and the files its own call wrote, or, where ``answers`` ({corpus index:
    {reference: answer}}) is given, are those answers: the precision
    control put in the program's place."""

    numbers = correct.Numbers(references)
    for k, o in enumerate(outcomes):
        t = tracks[o.track]
        label = f"outcome {k} ({Path(t.path).name})"
        for r in references:
            if answers is not None:
                got = answers[o.track][r.name]
            else:
                try:
                    got = r.served(o.result, source_path=t.path, run_dir=o.run_dir)
                except Exception as e:  # what the call produced cannot be read: not correct
                    numbers.unread(label, r, repr(e))
                    continue
            numbers.add(got, refs[o.track][r.name], label, r)
    return numbers


def run_cell(
    spec: Spec,
    cell: Cell,
    *,
    seed: int,
    seconds: float,
    trace: bool,
    t0: float,
    device: str = "cuda",
    log=lambda msg: print(msg, file=sys.stderr, flush=True),
    save_trace: Optional[Path] = None,
    check_device: Optional[Callable] = None,
) -> dict:
    """One run; returns the result line as a dict (``correct``,
    ``attempted``, ``failed``, ``metrics``, ``device``, optionally
    ``breakdown``, and last ``checks``). ``check_device(torch)`` may raise
    to stop the run before the program is imported; the corpus renders
    meanwhile."""

    on_card = device.startswith("cuda")
    work = Path(tempfile.mkdtemp(prefix=f"h100_bench_{cell.name}_"))
    try:
        with ThreadPoolExecutor(max_workers=1) as pool:
            def build() -> list:
                out = corpus.build(cell.config, seed, work)
                log(f"corpus: {len(out)} files, {sum(t.frames / t.sample_rate for t in out):.1f} s of audio, "
                    f"{time.perf_counter() - t0:.2f} s into the run")
                return out

            pending = pool.submit(build)
            import torch

            if check_device is not None:
                check_device(torch)
            import track_analyser_tpu_torch.pipeline  # noqa: F401  (imported while the corpus renders)

            if on_card:
                torch.zeros(1, device=device)
            log(f"torch, the program and the CUDA context: {time.perf_counter() - t0:.2f} s into the run")
            references = spec.references(cell)
            tracks = pending.result()
        driver = Driver(cell.traffic, cell.config, tracks, seed, device, work)
        warm = driver.warm(bucket_of)
        bad = [o.error for o in warm if o.error]
        if bad:
            raise RuntimeError(f"warm-up call failed: {bad[0]}")
        del warm
        if on_card:
            torch.cuda.synchronize()
        from track_analyser_tpu_torch.parallel import batch as program_batch

        program_batch.reset_stage_seconds()
        setup_s = time.perf_counter() - t0
        log(f"warm-up done: set-up {setup_s:.2f} s")

        window = driver.window(seconds)
        memory_peak = int(torch.cuda.max_memory_allocated()) if on_card else 0
        ctx = Context(cell.name, setup_s, window, tracks, stages=program_batch.stage_seconds(),
                      memory_peak_bytes=memory_peak)

        breakdown = None
        if trace:
            with stretch() as held:
                ctx.stretch_outcomes = driver.stretch()
            ctx.trace = held[0]
            if save_trace:
                save_trace.write_text(json.dumps(ctx.trace.to_json()))
            breakdown = {"device_ops": ctx.trace.top_device_ops(), "idle_gaps": ctx.trace.idle_gaps()}
        metrics = read_metrics(spec, cell.per_layer if trace else cell.end_to_end, ctx)

        # The window has closed: judge what it served against the reference.
        found = forbidden_modules()
        if found:
            raise SystemExit(f"forbidden modules loaded in the run: {found}")
        served = [o for o in window.outcomes if o.error is None]
        failed = len(window.outcomes) - len(served)
        for o in window.outcomes:
            if o.error:
                log(f"failed: {tracks[o.track].path}: {o.error.strip().splitlines()[-1]}")
        del driver, ctx
        if on_card:
            torch.cuda.empty_cache()
        t_ref = time.perf_counter()
        refs = _reference(tracks, [o.track for o in served], device, tf32=False, references=references)
        numbers = compare(served, refs, tracks, references)
        ok, checks = numbers.verdict(cell.config["limits"])
        log(f"reference: {len(refs)} files, {numbers.compared} results compared in "
            f"{time.perf_counter() - t_ref:.2f} s")
        for key, row in checks.items():
            log(f"check {key}: {row['value']!r} (limit {row['limit']!r}) at {numbers.where(key)}")
        result = {
            "correct": bool(ok and failed == 0 and served),
            "attempted": len(window.outcomes),
            "failed": failed,
            "metrics": metrics,
            "device": {
                "platform": "gpu" if on_card else "cpu",
                "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
                "count": cell.chips,
                "memory_peak_bytes": memory_peak,
            },
        }
        if trace:
            result["device"]["busy_s"] = held[0].busy_s()
            result["device"]["window_s"] = held[0].window_s
            result["breakdown"] = breakdown
        result["checks"] = checks
        return result
    finally:
        shutil.rmtree(work, ignore_errors=True)
