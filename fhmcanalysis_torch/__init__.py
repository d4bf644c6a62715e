"""FHMCAnalysis on PyTorch: flat-histogram Monte Carlo post-processing on CUDA.

The PyTorch counterpart of ``fhmcanalysis_tpu`` (the JAX reference, which
stays beside it).  Module layout and function names follow the JAX package
so each module's counterpart is easy to find; inside, the code is plain
PyTorch on float64 tensors with the state-point axis written out where the
JAX package used ``vmap``.

What runs today: the mu_1 reweight + segment + per-phase thermo sweep
(``core.pipeline.mu_sweep_thermo``), with its fused kernel written in CUDA
C++ for Hopper (``csrc/sweep_thermo.cu``, built at first use by
``_build.py``).  Importing the package needs neither ``nvcc`` nor a GPU.
"""

__version__ = "0.1.0"

from . import core  # noqa: E402,F401
from .core import moments, numerics, ops, pipeline, segment, state  # noqa: F401
from .core.state import Hist, HistMeta, from_host, make_hist, to_host  # noqa: F401

__all__ = [
    "Hist",
    "HistMeta",
    "from_host",
    "make_hist",
    "to_host",
    "moments",
    "numerics",
    "ops",
    "pipeline",
    "segment",
    "state",
]
