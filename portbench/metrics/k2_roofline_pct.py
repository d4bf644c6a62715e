"""k2_roofline_pct: the least time the card needs for the traced calls'
(mu_1, beta, dMu) product sweeps, as a share of the device time of the
launches of kernel K2 (core/cuda_mb, csrc/mb_sweep_thermo.cu) in the
traced window.  Work: lnPI, op, the moment rows the Taylor rows read (as
the reference's derivative engine reads them), the mu_1 grid and the
targets read once; the props dict written once; the tail's operations,
with K2's Taylor step a bin and key row, over the bins the outputs'
phase bounds cover."""

import re

from portbench import roofline as R

KERNEL = re.compile(r"(?<![A-Za-z0-9_])mb_sweep_thermo_kernel")


def read(ctx):
    if ctx.trace is None or not ctx.traced:
        return None
    device_s = ctx.trace.device_seconds(lambda name: KERNEL.search(name) is not None)
    if device_s <= 0:
        return None
    cfg, wl = ctx.cfg, ctx.wl
    N, S, P, smooth = cfg["N"], cfg["nspec"], cfg["max_phases"], cfg["smooth"]
    M, A, order = wl["M"], wl["A"], wl["order"]
    B = M * A
    rows = R.moment_rows(ctx.state["d"], cfg, order)
    nbytes = (2 * N + rows * N + M + A * S) * R.F64 + R.sweep_out_bytes(B, P, S)
    least = 0.0
    for t in ctx.traced:
        ops = R.tail_ops(B, N, smooth, int(t["keep"]["covered"]), *R.k2_ops(S, order))
        least += R.least_seconds(nbytes, ops)
    return 100.0 * least / device_s
