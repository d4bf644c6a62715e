"""points_per_s.kernel_bound: points_per_s in the cells where a kernel
does most of a call (sw573.sweep: K1), under a bound of their own, set
from their own spread, so that a kernel's gain or loss shows there."""


def read(ctx):
    return sum(c["work"]["points"] for c in ctx.calls) / ctx.window_s
