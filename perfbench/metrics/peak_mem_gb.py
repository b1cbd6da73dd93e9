"""peak_mem_gb: torch.cuda.max_memory_allocated() over set-up and window,
in 1e9 bytes."""


def read(ctx):
    return ctx.peak_bytes / 1e9 if ctx.peak_bytes else None
