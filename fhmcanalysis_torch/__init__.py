"""FHMCAnalysis on PyTorch: flat-histogram Monte Carlo post-processing on CUDA.

The PyTorch counterpart of ``fhmcanalysis_tpu`` (the JAX reference, which
stays beside it).  Module layout and function names follow the JAX package
so each module's counterpart is easy to find; inside, the code is plain
PyTorch on float64 tensors with the state-point axis written out where the
JAX package used ``vmap``.

What runs today: the mu_1 reweight + segment + per-phase thermo sweep
(``core.pipeline.mu_sweep_thermo``) and the (mu_1, beta, dMu)
extrapolating sweep (``core.pipeline.mu_beta_sweep_thermo``, over
``core.derivs`` / ``core.extrap``), each with its fused kernel written in
CUDA C++ for Hopper (``csrc/sweep_thermo.cu``, ``csrc/mb_sweep_thermo.cu``,
sharing ``csrc/thermo_tail.cuh``; built at first use by ``_build.py``).
Tensors live on the CUDA card unless the caller passes ``device="cpu"``.
Importing the package needs neither ``nvcc`` nor a GPU.
"""

__version__ = "0.1.0"

from . import core  # noqa: E402,F401
from .core import derivs, extrap, moments, numerics, ops, pipeline, segment, state  # noqa: F401
from .core.state import Hist, HistMeta, from_host, make_hist, to_host  # noqa: F401

__all__ = [
    "Hist",
    "HistMeta",
    "from_host",
    "make_hist",
    "to_host",
    "derivs",
    "extrap",
    "moments",
    "numerics",
    "ops",
    "pipeline",
    "segment",
    "state",
]
