"""idle_in_dispatch_pct.sweep: 100 x (the union of the program's
"dispatch" spans in the traced stretch minus the card's busy intervals) /
the stretch's wall time: the share of the stretch the card idles while the
host enqueues a graph."""

from h100_bench.spans import idle_in_pct


def read(ctx):
    return idle_in_pct(ctx, "dispatch")
