"""track_ms: the window's wall time over the calls made in it: the mean
wait for one analyse_track(path) in a closed loop, host clock."""


def read(ctx):
    if not ctx.window.outcomes or ctx.window.outcomes[0].latency_s is None:
        return None
    return ctx.window.seconds * 1e3 / ctx.window.calls
