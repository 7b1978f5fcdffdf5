"""median31_roofline.stems: the four sliding medians of an
analyse_track(path, use_stems=True) call, their bytes bound over the
device time of the kernels named below, in the traced stretch. A stretch
without such kernels reads nothing.

Each median reads its float32 input once and writes its output once,
over 3.35 TB/s, on the track's own frames (not the bucket's padding):
the analysis's two at (1025, 1 + n // 512) and the DSP separator's two
at (C, 2049, 1 + m // 1024), n the track's samples at the analysis rate,
m at its own rate (the separators run there) and C its channels."""

from h100_bench import roofline

KERNELS = ("median31_kernel",)
DSP_HOP = 1024
DSP_BINS = 2049  # n_fft 4096 // 2 + 1


def separator_median_bytes(samples: int, channels: int) -> int:
    """Bytes one of the DSP separator's medians must move: its (C, 2049, F)
    float32 input read once and its output written once."""

    return 2 * int(channels) * DSP_BINS * (1 + int(samples) // DSP_HOP) * 4


def call_bound_s(track) -> float:
    """The least time the four medians of one call on ``track`` (a corpus
    track) can take on the card."""

    samples = roofline.analysis_samples(track.frames, track.sample_rate)
    analysis = 2 * roofline.median31_bound_s(roofline.hpss_frames(samples))
    return analysis + 2 * separator_median_bytes(track.frames, track.channels) / roofline.HBM_BYTES_PER_S


def read(ctx):
    if ctx.trace is None:
        return None
    seconds, launches = ctx.trace.device_time_s(KERNELS)
    if not launches:
        return None
    served = [ctx.tracks[o.track] for o in ctx.stretch_outcomes if o.error is None]
    bound = sum(call_bound_s(t) for t in served)
    return 100.0 * bound / seconds
