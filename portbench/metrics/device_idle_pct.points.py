"""device_idle_pct.points: the share of the traced window in which no
operation ran on the device (the window less the union of the device
operations' intervals), in the cells that report points_per_s."""


def read(ctx):
    return None if ctx.trace is None else 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
