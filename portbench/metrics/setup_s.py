"""setup_s: seconds from the process's start to the first timed call:
importing torch and the program, the CUDA context, loading (in a
checkout's first run, building) the kernels, the seed's composites on
the card and the warm calls of the cell's own shapes."""


def read(ctx):
    return ctx.setup_s
