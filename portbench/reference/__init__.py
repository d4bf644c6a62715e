"""The benchmark's plain reference: plain PyTorch, importing nothing of
the program, that works out again from the benchmark's own inputs what
each timed call returns, so that ``correct`` compares the two.  Frozen
copies of the algorithm (segmentation, integration, the semigrand Taylor
rows), each in any float dtype:
the control runs it in float32.
"""
