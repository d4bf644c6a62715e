from . import cuda_iso, cuda_mb, cuda_sweep, derivs, extrap, moments, numerics, ops, pipeline, segment, segment2d, solve, state
from .state import Hist, HistMeta, from_host, make_hist, to_host

__all__ = [
    "Hist",
    "HistMeta",
    "from_host",
    "make_hist",
    "to_host",
    "cuda_iso",
    "cuda_mb",
    "cuda_sweep",
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
]
