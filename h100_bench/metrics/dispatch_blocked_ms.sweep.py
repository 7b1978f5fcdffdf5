"""dispatch_blocked_ms.sweep: the sum over the program's "dispatch" spans in
the traced stretch of (wall time - the thread's CPU time), per clip served
in the stretch, in ms: the enqueue's time off the CPU, mostly waiting for
the GIL."""

from h100_bench.spans import in_stretch, served_in_stretch


def read(ctx):
    mine = in_stretch(ctx, "dispatch")
    served = served_in_stretch(ctx)
    if mine is None or not served:
        return None
    return sum((r.end_ns - r.start_ns) - r.cpu_ns for r in mine) / 1e6 / served
