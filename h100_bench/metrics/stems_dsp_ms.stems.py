"""stems_dsp_ms.stems: the program's stage_seconds()["stems.dsp"] over the
window, per served call: the DSP separator (its "stems.dsp" span: upload,
STFT, HPSS, masks, four inverses and the readback)."""

from h100_bench.readers import per_track_ms


def read(ctx):
    return per_track_ms(ctx, "stems.dsp")
