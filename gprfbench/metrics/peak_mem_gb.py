"""peak_mem_gb: torch.cuda.max_memory_allocated over the window (the peak
is reset after set-up), in 1e9 bytes."""


def read(ctx):
    if not ctx.cuda:
        return None
    return ctx.memory_peak_bytes / 1e9
