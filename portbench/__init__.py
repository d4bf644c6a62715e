"""The benchmark of fhmcanalysis_torch on the card: ``run.py`` runs one
cell of ``BENCHMARK.json``; ``harness.py`` finds each cell's files by
name; ``reference/`` is the plain reference that decides ``correct``."""
