"""stems_ms.stems: the program's stage_seconds()["stems"] over the window,
per served analyse_track(path, use_stems=True) call: the whole stems layer
(its "stems" span: the second decode, both separators, the blend and the
four WAV writes)."""

from h100_bench.readers import per_track_ms


def read(ctx):
    return per_track_ms(ctx, "stems")
