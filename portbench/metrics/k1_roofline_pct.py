"""k1_roofline_pct: the least time the card needs for the traced calls'
mu sweeps (roofline.least_seconds), as a share of the device time of the
launches of kernel K1 (core/cuda_sweep, csrc/sweep_thermo.cu) in the
traced window.  Work: the entry's inputs as the user hands them over
(lnPI, op, the key moment rows <N_i>, <U>, the mu_1 grid) read once, its
outputs (the props dict) written once, and the tail's operations over
the bins the outputs' phase bounds cover."""

import re

from portbench import roofline as R

KERNEL = re.compile(r"(?<![A-Za-z0-9_])sweep_thermo_kernel")


def read(ctx):
    if ctx.trace is None or not ctx.traced:
        return None
    device_s = ctx.trace.device_seconds(lambda name: KERNEL.search(name) is not None)
    if device_s <= 0:
        return None
    N, S, P, smooth = ctx.cfg["N"], ctx.cfg["nspec"], ctx.cfg["max_phases"], ctx.cfg["smooth"]
    B = ctx.wl["points"]
    nbytes = (2 * N + (S + 1) * N + B) * R.F64 + R.sweep_out_bytes(B, P, S)
    least = 0.0
    for t in ctx.traced:
        ops = R.tail_ops(B, N, smooth, int(t["keep"]["covered"]), *R.k1_ops(S))
        least += R.least_seconds(nbytes, ops)
    return 100.0 * least / device_s
