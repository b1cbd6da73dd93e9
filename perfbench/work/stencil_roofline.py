"""The stencil block-SpMV kernel's share of its roofline over the traced
window, in %, for one instance (``stencil_spmv_kernel<V, X>``).

Every launch of the instance in the trace counts, with its own time and
its own work: the launch's grid and block (one thread per node) say which
multigrid level it ran on, the level with ceil(npad / block) = grid, and
``stencil_spmv_work`` gives that level's bytes and operations in the
instance's types. The coarsest levels can share one padded npad, so one
grid can stand for several of them; their work differs only in the
offsets' edge slots (under 1 %), and the least of it is taken, so that
the share is never read too high. The share is the
summed least time of the launches over their summed device time. None
where the trace holds no launch of the instance, or a launch that matches
no level, or the solver has no stencil levels (the public ``levels``,
each with ``offsets`` and ``npad``)."""
import math

from perfbench.work.kernels import bound_s, stencil_spmv_work

ITEMSIZE = {"float": 4, "double": 8}


def roofline(ctx, instance: str):
    """``instance``: the template arguments, as "float, float"."""
    if ctx.trace is None:
        return None
    levels = getattr(ctx.system, "levels", None)
    if not levels or any(getattr(lvl, "offsets", None) is None for lvl in levels):
        return None
    found = ctx.trace["launches"](f"stencil_spmv_kernel<{instance}>")
    if not found:
        return None
    v, x = (ITEMSIZE[t.strip()] for t in instance.split(","))
    least = secs = 0.0
    for _, grid, block, sec in found:
        if not grid or not block:
            return None
        bounds = [bound_s(*stencil_spmv_work(lvl.offsets, lvl.npad, v, x), v, ctx.card_name) for lvl in levels
                  if math.ceil(lvl.npad / block[0]) == grid[0]]
        if not bounds:
            return None
        least += min(bounds)
        secs += sec
    return 100.0 * least / secs if secs > 0 else None
