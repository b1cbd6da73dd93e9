"""pcg.iters: the CG iterations of the window's solves, their mean, as the
entry reports them (the mix's ``iters`` attribute)."""


def read(ctx):
    return sum(ctx.iters) / len(ctx.iters)
