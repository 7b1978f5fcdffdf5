"""device_idle_pct.stems: 100 x (1 - the union of kernel, copy and memset
intervals on the card / the traced stretch's wall time), torch.profiler."""

from h100_bench.readers import idle_pct


def read(ctx):
    return idle_pct(ctx)
