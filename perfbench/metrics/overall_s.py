"""overall_s: the window's wall seconds over the load cases it completed,
each through the entry's whole per-case path (for solve_fused: the
assembly of every level, the preconditioner's set-up and the solve to the
mix's tolerance), synchronised."""


def read(ctx):
    return ctx.window_s / ctx.solves
