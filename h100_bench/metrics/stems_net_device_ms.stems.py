"""stems_net_device_ms.stems: the program's stage_seconds()["stems.net_device"]
over the window, per served call: the mask net's upload, forward pass and
inverses on the card's clock (two CUDA events around them)."""

from h100_bench.readers import per_track_ms


def read(ctx):
    return per_track_ms(ctx, "stems.net_device")
