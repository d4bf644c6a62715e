"""sweep2d_host_syncs: the program's host_syncs a call of a 2-D state
sweep (its waits for the card, one at each fetch of results), read from
its counters around every call of the window; None where the program does
not count the 2-D sweep (no sweep2d.states counter moved)."""

from portbench import spans

NAMES = ("host_syncs", "sweep2d.states")


def counters():
    return {name: (lambda name=name: spans.counter(name) or 0) for name in NAMES}


def read(ctx):
    if not ctx.calls or not sum(c["counters"]["sweep2d.states"] for c in ctx.calls):
        return None
    return sum(c["counters"]["host_syncs"] for c in ctx.calls) / len(ctx.calls)
