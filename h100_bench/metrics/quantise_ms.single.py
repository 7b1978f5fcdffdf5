"""quantise_ms.single: the program's stage_seconds()["quantise"] over the window, per
served analyse_track call (its "quantise" span on the single path)."""

from h100_bench.readers import per_track_ms


def read(ctx):
    return per_track_ms(ctx, "quantise")
