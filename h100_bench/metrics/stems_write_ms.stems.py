"""stems_write_ms.stems: the program's stage_seconds()["stems.write"] over
the window, per served call: quantising and writing the four stereo
PCM_16 WAVs."""

from h100_bench.readers import per_track_ms


def read(ctx):
    return per_track_ms(ctx, "stems.write")
