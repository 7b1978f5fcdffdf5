"""wav_decode_pct.single: 100 x the program's "decode" spans in the traced
stretch that hold a "decode.wav" span (the native one-pass WAV decode)
over its "decode" spans there: the share of served calls whose decode
took the one-pass path. A program that records no "decode.wav" span reads
nothing."""

from h100_bench.spans import in_stretch


def read(ctx):
    passes = in_stretch(ctx, "decode.wav")
    decodes = in_stretch(ctx, "decode")
    if passes is None or decodes is None:
        return None
    holders = {r.parent_id for r in passes}
    return 100.0 * sum(1 for r in decodes if r.span_id in holders) / len(decodes)
