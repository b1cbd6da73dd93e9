"""solve_s: the window's wall seconds over the load cases it completed,
each solved to the mix's tolerance by a solver built in set-up,
synchronised."""


def read(ctx):
    return ctx.window_s / ctx.solves
