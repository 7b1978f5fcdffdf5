"""decode_ms.sweep: the program's stage_seconds()["decode"] over the window,
per served track (summed over the sweep's threads, so stages overlap)."""

from h100_bench.readers import per_track_ms


def read(ctx):
    return per_track_ms(ctx, "decode")
