"""audio_s_per_s.sweep: seconds of audio of every source served in the
window over the window's wall time, each call's fill and drain included,
host clock. Per layer: its runs spread too widely for a bound (PERF.md)."""


def read(ctx):
    if not ctx.window.outcomes or ctx.window.outcomes[0].latency_s is not None:
        return None
    return ctx.audio_seconds(ctx.done) / ctx.window.seconds
