"""device_idle_pct.kernel_bound: as device_idle_pct.points, in the cells
that report points_per_s.kernel_bound."""


def read(ctx):
    return None if ctx.trace is None else 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
