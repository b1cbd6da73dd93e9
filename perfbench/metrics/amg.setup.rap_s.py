"""amg.setup.rap_s: the seconds of the AMG set-up's Galerkin products
R A P on the host, as the solver records them (``setup_timings["rap"]``)."""


def read(ctx):
    timings = getattr(ctx.system, "setup_timings", None)
    return None if timings is None else timings.get("rap")
