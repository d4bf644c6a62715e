"""setup_kernel_load_s: seconds this run spent loading and checking the
program's kernel libraries, and building any not yet built (its counters
kernel.load_s and kernel.build_s), a part of setup_s."""

from portbench import spans


def read(ctx):
    load = spans.counter("kernel.load_s")
    return None if load is None else load + (spans.counter("kernel.build_s") or 0.0)
