"""The benchmark's own tests: ``python -m pytest portbench/tests``.  Those
marked gpu need a CUDA card and skip without one; the rest run the
harness on the CPU at small sizes."""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from portbench import harness  # noqa: E402

# sizes a CPU test run holds, per cell
SMALL = {
    "sw573.sweep": {"points": 256, "trace_calls": 2},
    "bin31.mbsweep": {"M": 64, "A": 8, "trace_calls": 2},
}

BENCH = harness.benchmark()


@pytest.fixture
def cuda():
    """The CUDA card; skips where there is none (decided here, at run time)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
