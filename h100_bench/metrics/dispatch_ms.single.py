"""dispatch_ms.single: the program's stage_seconds()["dispatch"] over the window, per
served analyse_track call (its "dispatch" span on the single path)."""

from h100_bench.readers import per_track_ms


def read(ctx):
    return per_track_ms(ctx, "dispatch")
