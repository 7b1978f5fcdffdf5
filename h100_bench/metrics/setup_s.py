"""setup_s: process start to the first timed call (imports, CUDA context,
kernel builds or their cache, audio synthesis, warm-up), host clock."""


def read(ctx):
    return ctx.setup_s
