"""device_memory_peak_mib: the card memory the run's process held at its
peak, set-up and window included (the CUDA caching allocator's high-water
mark of allocated bytes, the reading behind ``memory_peak_bytes``), in
MiB. Nothing without a card."""


def read(ctx):
    return ctx.memory_peak_bytes / 2**20 if ctx.memory_peak_bytes else None
