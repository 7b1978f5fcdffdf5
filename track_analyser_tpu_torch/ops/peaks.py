"""Peak picking and onset selection (host side, numpy).

The envelopes these operate on are tiny (one scalar per hop — ~86 values
per second), and the `wait` constraint makes selection inherently greedy /
sequential, so this stays on host by design: the device computes the
envelope, the host picks peaks. Semantics mirror librosa.util.peak_pick and
librosa.onset.{onset_detect, onset_backtrack}; the code is the JAX
package's ``ops/peaks.py`` unchanged, so both packages pick the same peaks.
"""

from __future__ import annotations

import numpy as np

__all__ = ["peak_pick", "onset_detect", "onset_backtrack"]


def _sliding_max(x: np.ndarray, pre: int, post: int) -> np.ndarray:
    """max(x[i-pre : i+post]) with truncation at the edges (vectorised)."""

    n = x.size
    width = pre + post
    if width <= 0:
        return x.copy()
    padded = np.full(n + width - 1, -np.inf, dtype=np.float64)
    padded[pre : pre + n] = x
    windows = np.lib.stride_tricks.sliding_window_view(padded, width)
    return windows.max(axis=-1)


def _sliding_mean(x: np.ndarray, pre: int, post: int) -> np.ndarray:
    n = x.size
    cs = np.concatenate(([0.0], np.cumsum(x, dtype=np.float64)))
    lo = np.maximum(0, np.arange(n) - pre)
    hi = np.minimum(n, np.arange(n) + post)
    counts = np.maximum(hi - lo, 1)
    return (cs[hi] - cs[lo]) / counts


def peak_pick(
    x: np.ndarray,
    *,
    pre_max: int,
    post_max: int,
    pre_avg: int,
    post_avg: int,
    delta: float,
    wait: int,
) -> np.ndarray:
    """Greedy peak picking: local max, above local mean + delta, >= wait apart."""

    x = np.asarray(x, dtype=np.float64)
    if x.size == 0:
        return np.zeros(0, dtype=int)
    pre_max = int(np.ceil(pre_max))
    post_max = int(np.ceil(post_max))
    pre_avg = int(np.ceil(pre_avg))
    post_avg = int(np.ceil(post_avg))
    wait = int(np.ceil(wait))

    mov_max = _sliding_max(x, pre_max, post_max)
    mov_avg = _sliding_mean(x, pre_avg, post_avg)

    candidates = (x == mov_max) & (x >= mov_avg + delta) & (x > 0)
    peaks = []
    last = -np.inf
    for i in np.flatnonzero(candidates):
        if i > last + wait:
            peaks.append(int(i))
            last = i
    return np.asarray(peaks, dtype=int)


def onset_detect(
    onset_envelope: np.ndarray,
    sr: int,
    hop_length: int,
    *,
    backtrack: bool = True,
    delta: "float | None" = None,
) -> np.ndarray:
    """Onset frames from an envelope (30 ms max window, 100 ms mean window,
    30 ms wait — the windows the reference inherits from librosa).

    Unlike librosa's absolute ``delta=0.07`` (which drowns in broadband
    noise flux), the default threshold is scale-invariant:
    ``max(0.07, 0.1 * max(envelope))``.
    """

    env = np.asarray(onset_envelope, dtype=np.float64)
    if env.size == 0 or not np.any(env) or not np.all(np.isfinite(env)):
        return np.zeros(0, dtype=int)
    if delta is None:
        delta = max(0.07, 0.1 * float(env.max()))
    onsets = peak_pick(
        env,
        pre_max=int(0.03 * sr // hop_length),
        post_max=int(0.00 * sr // hop_length + 1),
        pre_avg=int(0.10 * sr // hop_length),
        post_avg=int(0.10 * sr // hop_length + 1),
        wait=int(0.03 * sr // hop_length),
        delta=delta,
    )
    if backtrack:
        onsets = onset_backtrack(onsets, env)
    return onsets


def onset_backtrack(events: np.ndarray, energy: np.ndarray) -> np.ndarray:
    """Roll each event back to the preceding local minimum of ``energy``."""

    if events.size == 0:
        return events
    minima = 1 + np.flatnonzero(
        (energy[1:-1] <= energy[:-2]) & (energy[1:-1] < energy[2:])
    )
    minima = np.unique(np.concatenate(([0], minima)))
    # For each event, the largest minimum <= event.
    pos = np.searchsorted(minima, events, side="right") - 1
    pos = np.clip(pos, 0, minima.size - 1)
    return minima[pos]
