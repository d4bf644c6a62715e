"""points_per_s: the state points that the window's calls completed (mu
points, isopleth cells, (mu, beta, dMu) targets), over the window's
seconds on the host's clock, in the cells where host work between the
kernels' launches takes much of a call (bin31.mbsweep: K2's prologue)."""


def read(ctx):
    return sum(c["work"]["points"] for c in ctx.calls) / ctx.window_s
