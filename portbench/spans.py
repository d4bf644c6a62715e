"""What the per-layer readers of program spans take from a traced window.

The program marks its layers as host ranges named ``fhmc.*`` on the
profiler's clock (``fhmc.entry.*`` a whole call; ``fhmc.prologue.*``,
``fhmc.launch.*``, ``fhmc.post.*``, ``fhmc.solver.*`` inside it), which
the harness's ``Trace`` keeps among its host events.  A program without
such spans gives these readers nothing to read, and they return None.
Times are the trace's microseconds.
"""

from __future__ import annotations


def union(intervals) -> list:
    """The intervals (a, b) merged where they overlap or touch, sorted."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def length(intervals) -> float:
    return sum(b - a for a, b in intervals)


def overlap(xs, ys) -> float:
    """The length of the intersection of two merged, sorted interval lists."""
    i = j = 0
    total = 0.0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if b > a:
            total += b - a
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def inside(trace, prefix: str) -> list:
    """The union of the host spans whose names start with prefix, clipped
    to the traced window; [] where the program has none."""
    return union((max(a, trace.t0), min(b, trace.t1)) for n, a, b in trace.host if n.startswith(prefix) and b > trace.t0 and a < trace.t1)


def idle_inside(trace, prefix: str):
    """Seconds of the traced window in which no device operation ran while
    the host was inside a span named prefix*, or None without such spans."""
    spans = inside(trace, prefix)
    if not spans:
        return None
    return (length(spans) - overlap(spans, union(trace.busy))) / 1e6


def host_ms_per_call(ctx, prefix: str):
    """Host milliseconds inside the spans named prefix* per traced call, or
    None without a trace or such spans."""
    if ctx.trace is None or not ctx.traced:
        return None
    spans = inside(ctx.trace, prefix)
    if not spans:
        return None
    return length(spans) / 1e3 / len(ctx.traced)


def program_idle_pct(ctx):
    """The share of the traced window, in percent, in which the device was
    idle while the host was inside one of the program's entries: the part
    of the device's idle share that the program's own host code causes."""
    if ctx.trace is None:
        return None
    idle = idle_inside(ctx.trace, "fhmc.entry.")
    return None if idle is None else 100.0 * idle / ctx.trace.window_s


def counter(name: str):
    """The program's counter name, or None where the program keeps no such
    counter."""
    try:
        from fhmcanalysis_torch.utils import profiling
    except ImportError:
        return None
    read = getattr(profiling, "counters", None)
    return None if read is None else read().get(name)
