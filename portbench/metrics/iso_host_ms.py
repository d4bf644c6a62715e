"""iso_host_ms: host milliseconds a traced call of make_grid spends in the
isopleth's host shell (the union of the spans fhmc.prologue.iso_bracket:
the bracket and weights of every dMu_2 row; fhmc.prologue.iso: each
bracketing source's reweight, rows and targets and the stacked layouts;
fhmc.post.iso_copy: the five grids copied back to numpy), per traced call;
None where the program has none of these spans.

The first copy waits for kernel K3, which make_grid launches without a
wait of its own: each copy span counts only from the end of the last
iso_grid_kernel launch on the device timeline that ends inside it, so the
card's time is not the shell's."""

import re

from portbench import spans

KERNEL = re.compile(r"(?<![A-Za-z0-9_])iso_grid_kernel")
PREFIXES = ("fhmc.prologue.iso_bracket", "fhmc.prologue.iso")


def _after_k3(trace, copies) -> list:
    """Each copy span from the end of the last K3 launch inside it on."""
    ends = [b for n, a, b in trace.ops if KERNEL.search(n)]
    out = []
    for a, b in copies:
        done = max((e for e in ends if a < e <= b), default=a)
        if done < b:
            out.append((done, b))
    return out


def read(ctx):
    if ctx.trace is None or not ctx.traced:
        return None
    found = [(a, b) for p in PREFIXES for a, b in spans.inside(ctx.trace, p)]
    found = spans.union(found + _after_k3(ctx.trace, spans.inside(ctx.trace, "fhmc.post.iso_copy")))
    return spans.length(found) / 1e3 / len(ctx.traced) if found else None
