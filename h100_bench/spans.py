"""The program's own spans (``track_analyser_tpu_torch.profiling``) in a
run's traced stretch, for the metric readers.

The program records its spans while a ``torch.profiler`` session is
active, as the traced stretch's is, on the clock the profiler stamps its
events with; a span is the stretch's when it lies inside the stretch's
marker. A program that records no spans gives None, never an error.
"""

from __future__ import annotations

import bisect
from typing import List, Optional, Tuple


def recorded() -> Optional[list]:
    """Every span the program has recorded, or None where it records none."""

    try:
        from track_analyser_tpu_torch import profiling
    except ImportError:
        return None
    read = getattr(profiling, "spans", None)
    return None if read is None else read()


def in_stretch(ctx, name: str) -> Optional[list]:
    """The spans named ``name`` inside the traced stretch; None without a
    trace, or where the program recorded none of that name there."""

    records = recorded() if ctx.trace is not None else None
    if not records:
        return None
    lo, hi = ctx.trace.start_us * 1e3, ctx.trace.end_us * 1e3
    mine = [r for r in records if r.name == name and lo <= r.start_ns and r.end_ns <= hi]
    return mine or None


def _union(intervals) -> List[Tuple[float, float]]:
    merged: List[list] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def idle_in_pct(ctx, name: str) -> Optional[float]:
    """100 x (the union of the stretch's ``name`` spans minus the card's
    busy intervals) / the stretch's wall time."""

    mine = in_stretch(ctx, name)
    if mine is None or not ctx.trace.device or ctx.trace.window_s <= 0:
        return None
    busy = ctx.trace.busy_intervals()  # disjoint, sorted
    ends = [e for _s, e in busy]
    idle_us = 0.0
    for s, e in _union((r.start_ns / 1e3, r.end_ns / 1e3) for r in mine):
        idle_us += e - s
        for bs, be in busy[bisect.bisect_right(ends, s):]:
            if bs >= e:
                break
            idle_us -= min(e, be) - max(s, bs)
    return 100.0 * idle_us / 1e6 / ctx.trace.window_s


def served_in_stretch(ctx) -> int:
    return sum(1 for o in ctx.stretch_outcomes if o.error is None)
