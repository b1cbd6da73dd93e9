"""setup_s: seconds from the start of the run's process to the start of
the window: imports, the kernels' load (or build), the mesh, the solver's
constructor, the load cases and the warm-up solves."""


def read(ctx):
    return ctx.setup_s
