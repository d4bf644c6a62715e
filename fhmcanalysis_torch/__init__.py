"""FHMCAnalysis on PyTorch: flat-histogram Monte Carlo post-processing on CUDA.

The PyTorch counterpart of ``fhmcanalysis_tpu`` (the JAX reference, which
stays beside it).  Module layout and function names follow the JAX package
so each module's counterpart is easy to find; inside, the code is plain
PyTorch on float64 tensors with the state-point axis written out where the
JAX package used ``vmap``.

What runs today: the mu_1 reweight + segment + per-phase thermo sweep
(``core.pipeline.mu_sweep_thermo``), the (mu_1, beta, dMu) extrapolating
sweep (``core.pipeline.mu_beta_sweep_thermo``, over ``core.derivs`` /
``core.extrap``), the coexistence solver (``core.solve``, on the first
two's kernels) and the binary isopleth surface
(``binary.isopleth.isopleth(...).make_grid``), each with its fused kernel
written in CUDA C++ for Hopper (``csrc/sweep_thermo.cu``,
``csrc/mb_sweep_thermo.cu``, ``csrc/iso_grid.cu``, sharing
``csrc/thermo_tail.cuh``; built at first use by ``_build.py``); and the
host class shells ``histogram.ntot`` / ``histogram.n1`` with their netCDF
reader and writer (``io``, which imports ``h5py`` only when a file is
read or written), with ``utils.profiling`` for traces, spans and counters; and the
2-D surface path: ``two_dim.pore_state_sweep`` over slit-pore lnPI(h, N_tot)
surfaces and ``two_dim.joint_state_sweep`` over binary lnPI(N_1, N_tot)
surfaces, on ``core.segment2d`` (surface build, a device watershed and the
per-phase analysis in plain PyTorch on the card; no Pallas kernel lies on
the JAX package's 2-D path), the class ``two_dim.pore_hist``, and the host
flood ``two_dim.imaging`` with its native C++ build (``native``, g++ at
first use) as the reference-exact cross-check arm; and window patching
(``win_patch``: FHMCSimulation, checkpoint and FEASST window files into
one composite, host numpy over the native table reader
``native.read_table``), whose ``to_composite()`` hands the composite to
``histogram.ntot.histogram.from_composite`` without a file; and the
multi-device split (``parallel``: a mesh over a list of devices, one
contiguous block of each state-point grid per device through the
single-device call and its kernel, behind ``make_grid(mesh=...)`` and the
2-D sweeps' ``mesh=`` too, and the halo exchange of long surfaces).
Tensors live on the CUDA card unless the caller passes ``device="cpu"``.
Importing the package needs neither ``nvcc`` nor a GPU.
"""

import time as _time

# the package's import is timed from here to its last line (utils.profiling
# counter setup.import_s); torch's own import counts too where the caller
# has not imported torch first
_T_IMPORT = _time.perf_counter()

__version__ = "0.1.0"

from . import binary, core, histogram, io, native, parallel, two_dim, utils, win_patch  # noqa: E402,F401
from .core import derivs, extrap, moments, numerics, ops, pipeline, segment, segment2d, solve, state  # noqa: F401
from .core.state import Hist, HistMeta, from_host, make_hist, to_host  # noqa: F401

__all__ = [
    "Hist",
    "HistMeta",
    "from_host",
    "make_hist",
    "to_host",
    "binary",
    "histogram",
    "io",
    "native",
    "parallel",
    "derivs",
    "extrap",
    "moments",
    "numerics",
    "ops",
    "pipeline",
    "segment",
    "segment2d",
    "solve",
    "state",
    "two_dim",
    "utils",
    "win_patch",
]

utils.profiling.add("setup.import_s", _time.perf_counter() - _T_IMPORT)
