"""mb_prologue_ms: host milliseconds a traced call spends inside the
program's prologue spans (fhmc.prologue.*: for the (mu_1, beta, dMu)
sweep its targets and its mu-independent Taylor rows), the union of
their intervals over the traced window, per traced call."""

from portbench import spans


def read(ctx):
    return spans.host_ms_per_call(ctx, "fhmc.prologue.")
