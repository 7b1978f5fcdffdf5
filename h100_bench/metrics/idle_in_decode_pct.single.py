"""idle_in_decode_pct.single: 100 x (the union of the program's "decode"
spans in the traced stretch minus the card's busy intervals) / the
stretch's wall time: the share of the stretch the card idles while the
host decodes."""

from h100_bench.spans import idle_in_pct


def read(ctx):
    return idle_in_pct(ctx, "decode")
