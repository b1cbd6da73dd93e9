"""pcg.ms_per_iter: wall milliseconds per CG iteration over the untraced
part of the traced run's window (the solves after the profiler stopped);
over the whole window where none follows the traced part."""


def read(ctx):
    rest = ctx.iters[ctx.traced_solves:]
    if rest and sum(rest):
        return (ctx.window_s - ctx.traced_s) * 1e3 / sum(rest)
    n = sum(ctx.iters)
    return ctx.window_s * 1e3 / n if n else None
