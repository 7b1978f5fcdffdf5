"""graph_replay_pct.single: 100 x the program's "graph_replay" spans in the
traced stretch over its "dispatch" spans there: the share of dispatches
that replayed a captured CUDA graph. A program that records no
"graph_replay" span reads nothing."""

from h100_bench.spans import in_stretch


def read(ctx):
    replays = in_stretch(ctx, "graph_replay")
    dispatches = in_stretch(ctx, "dispatch")
    if replays is None or dispatches is None:
        return None
    return 100.0 * len(replays) / len(dispatches)
