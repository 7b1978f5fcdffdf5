"""queue_wait_ms.sweep: the program's stage_seconds()["queue_wait"] over the window,
per served clip (summed over the sweep's threads)."""

from h100_bench.readers import per_track_ms


def read(ctx):
    return per_track_ms(ctx, "queue_wait")
