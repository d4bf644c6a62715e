from . import cuda_b2d, cuda_iso, cuda_mb, cuda_sweep, cuda_ws2d, derivs, extrap, launch, moments, numerics, ops, pipeline, segment, segment2d, solve, state
from .state import Hist, HistMeta, from_host, make_hist, to_host

__all__ = [
    "Hist",
    "HistMeta",
    "from_host",
    "make_hist",
    "to_host",
    "cuda_b2d",
    "cuda_iso",
    "cuda_mb",
    "cuda_sweep",
    "cuda_ws2d",
    "derivs",
    "extrap",
    "launch",
    "moments",
    "numerics",
    "ops",
    "pipeline",
    "segment",
    "segment2d",
    "solve",
    "state",
]
