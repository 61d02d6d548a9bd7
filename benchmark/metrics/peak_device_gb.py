"""torch.cuda.max_memory_allocated() over set-up and window, after
reset_peak_memory_stats() at the process's start, in GB (1e9 bytes)."""


def read(ctx):
    peak = ctx.get('memory_peak_bytes')
    return peak / 1e9 if peak else None
