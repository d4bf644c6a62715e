"""program_idle_pct.kernel_bound: as program_idle_pct.points, in the cells
that report points_per_s.kernel_bound."""

from portbench import spans


def read(ctx):
    return spans.program_idle_pct(ctx)
