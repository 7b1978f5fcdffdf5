"""stems_net_ms.stems: the program's stage_seconds()["stems.net"] over the
window, per served call: the mask net on the host's clock (its "stems.net"
span: the upload, the forward pass, the four inverses and the readback)."""

from h100_bench.readers import per_track_ms


def read(ctx):
    return per_track_ms(ctx, "stems.net")
