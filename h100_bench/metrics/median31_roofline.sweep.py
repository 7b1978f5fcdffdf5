"""median31_roofline.sweep: HPSS's two sliding medians a track, their
bytes bound (each (1025, F) float32 input read once and output written
once, over 3.35 TB/s; F the track's own frames) over the device time of
the kernels named below, in the traced stretch. A stretch without such
kernels reads nothing."""

from h100_bench import roofline

KERNELS = ("median31_kernel",)


def read(ctx):
    if ctx.trace is None:
        return None
    seconds, launches = ctx.trace.device_time_s(KERNELS)
    if not launches:
        return None
    served = [ctx.tracks[o.track] for o in ctx.stretch_outcomes if o.error is None]
    bound = sum(
        2 * roofline.median31_bound_s(roofline.hpss_frames(roofline.analysis_samples(t.frames, t.sample_rate)))
        for t in served
    )
    return 100.0 * bound / seconds
