"""iso_host_syncs: the program's host_syncs a call of make_grid (its waits
for the card: the grids' copies back to numpy), read from its counters
around every call of the window; None where the program does not count
the lattice (no iso.cells counter moved)."""

from portbench import spans

NAMES = ("host_syncs", "iso.cells")


def counters():
    return {name: (lambda name=name: spans.counter(name) or 0) for name in NAMES}


def read(ctx):
    if not ctx.calls or not sum(c["counters"]["iso.cells"] for c in ctx.calls):
        return None
    return sum(c["counters"]["host_syncs"] for c in ctx.calls) / len(ctx.calls)
