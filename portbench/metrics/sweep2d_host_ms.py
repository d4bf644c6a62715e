"""sweep2d_host_ms: host milliseconds a traced call of a 2-D state sweep
spends in its serial host work before the first launch and after the wait
(the union of the spans fhmc.prologue.sweep2d: the histogram's checks, h,
F(h), the mask, the footprint and _props_inputs' copies of the mask, the
edges and the property surfaces to the card; fhmc.post.assemble2d: fail
codes, local maxima and the dict; fhmc.post.flood2d: the host flood or
the tie fallback), per traced call; None where the program has none of
these spans."""

from portbench import spans

PREFIXES = ("fhmc.prologue.sweep2d", "fhmc.post.assemble2d", "fhmc.post.flood2d")


def read(ctx):
    if ctx.trace is None or not ctx.traced:
        return None
    found = spans.union(ab for p in PREFIXES for ab in spans.inside(ctx.trace, p))
    return spans.length(found) / 1e3 / len(ctx.traced) if found else None
