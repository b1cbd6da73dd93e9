"""device.idle_share: 1 - (the union of the intervals in which a device
operation ran) / (the traced window's wall time), from the profiler's
trace of the window's first seconds."""


def read(ctx):
    t = ctx.trace
    if t is None or t["busy_s"] <= 0:
        return None
    return 1.0 - t["busy_s"] / t["window_s"]
