"""graph_ms.sweep: the program's stage_seconds()["graph"] (CUDA events
around each graph, so an enqueue stall between them counts) over the
window, per served track."""

from h100_bench.readers import per_track_ms


def read(ctx):
    return per_track_ms(ctx, "graph")
