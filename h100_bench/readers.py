"""Shared arithmetic of the metric readers in ``metrics/``.

Each reader takes the run's ``harness.Context`` and returns a number, or
None where it finds nothing to read (the harness then leaves the metric
out of the result line).
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def per_track_ms(ctx, stage: str) -> Optional[float]:
    """``stage_seconds()[stage]`` over the window, in ms per served track
    (the counters are summed over the program's threads)."""

    done = len(ctx.done)
    if stage not in ctx.stages or not done:
        return None
    return ctx.stages[stage] * 1e3 / done


def latencies_ms(ctx) -> np.ndarray:
    return np.array([o.latency_s for o in ctx.window.outcomes if o.latency_s is not None]) * 1e3


def idle_pct(ctx) -> Optional[float]:
    """Share of the traced stretch in which no kernel, copy or memset ran
    on the card."""

    if ctx.trace is None or not ctx.trace.device or ctx.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s() / ctx.trace.window_s)
