"""k3_roofline_pct: the least time the card needs for the traced calls'
isopleth lattices (roofline.least_seconds over roofline_iso's bytes and
operations), as a share of the device time of the launches of kernel K3
(core/cuda_iso, csrc/iso_grid.cu) in the traced window.  Work: each
bracketing source's lnPI, op and the moment rows its Taylor rows read (as
the reference's derivative engine reads them), the lattice's axes, the
rows' sources and weights read once; the five grids written once; the
tail's operations with K3's two sides and mix over every cell's N bins."""

import re

from portbench import roofline as R, roofline_iso as RI
from portbench.reference import iso

KERNEL = re.compile(r"(?<![A-Za-z0-9_])iso_grid_kernel")


def read(ctx):
    if ctx.trace is None or not ctx.traced:
        return None
    device_s = ctx.trace.device_seconds(lambda name: KERNEL.search(name) is not None)
    if device_s <= 0:
        return None
    cfg, wl, st = ctx.cfg, ctx.wl, ctx.state
    N, order = cfg["N"], cfg["order"]
    d0 = min(st["comps"])
    rows = R.moment_rows(dict(st["comps"][d0], curr_mu=[0.0, d0], curr_beta=cfg["beta"]), cfg, order)
    ops = RI.lattice_ops(wl["NX"], wl["NY"], N, cfg["smooth"], order)
    least = 0.0
    for t in ctx.traced:
        _, dmu2_b, delta = ctx.entry.make(st, t["p"])
        W = RI.sources_named(st["comps"], iso.axis(dmu2_b, delta[1]))
        least += R.least_seconds(RI.lattice_bytes(W, rows, N, wl["NX"], wl["NY"]), ops)
    return 100.0 * least / device_s
