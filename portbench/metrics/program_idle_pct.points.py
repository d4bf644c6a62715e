"""program_idle_pct.points: the share of the traced window in which no
operation ran on the device while the host was inside one of the
program's entry spans (fhmc.entry.*), in the cells that report
points_per_s: the part of device_idle_pct.points that the program's own
host code causes; the rest is the harness, the entry file's synchronize
and the time between calls.  Read from the same trace."""

from portbench import spans


def read(ctx):
    return spans.program_idle_pct(ctx)
