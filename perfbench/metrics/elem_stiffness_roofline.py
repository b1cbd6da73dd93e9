"""elem_stiffness_roofline: the element-stiffness kernel's share of its
roofline over the traced window, in %.

Every solve of the window assembles every multigrid level, so the work is
the element count of all levels times the traced window's solves, 8 (3m + 36m^2)
bytes and ELEM_OPS[m] operations per element; the time is the summed
device time of the kernel's launches in the trace (``tri_stiffness_kernel``
or ``quad_stiffness_kernel``). Nothing to read where the trace has no
launch of it."""
from perfbench.work.kernels import bound_s, elem_work

KERNELS = {3: "tri_stiffness_kernel", 4: "quad_stiffness_kernel"}


def read(ctx):
    if ctx.trace is None:
        return None
    m = ctx.plate.conn.shape[1]
    secs = sum(s for name, (s, _) in ctx.trace["kernels"].items() if KERNELS[m] in name)
    systems = getattr(ctx.system, "_systems", None)
    if secs <= 0 or not systems:
        return None
    per_solve = sum(len(s.mesh.tri) + len(s.mesh.quad) for s in systems)
    nbytes, ops = elem_work(m, per_solve * ctx.traced_solves)
    return 100.0 * bound_s(nbytes, ops, 8, ctx.card_name) / secs
