"""setup_import_s: seconds the program's own import took in this run
(its counter setup.import_s: the package's first line to its last, torch
already imported), a part of setup_s."""

from portbench import spans


def read(ctx):
    return spans.counter("setup.import_s")
