"""The 2-D boundary integrals kernel (CUDA, Hopper) and its wrapper.

Replaces, on CUDA tensors, the plain one-hot engine of
``segment2d._boundary_batch``, which the JAX package runs as jnp
operations on XLA (its ``core/segment2d.py``): for each label pair, two
masked passes over [8, S, H, N] tensors of pair keys and neighbour
values, ~200 GB of traffic for S = 1,024 states of 96 x 385 to find a
few thousand contributions a state.  The kernel, ``csrc/boundary2d.cu``,
reads each state's labels once and its lnPI only at the boundary, keeps
the contributions in a list in shared memory and reduces them there; its
header says how.  It computes the one-hot engine's formulas: max_val
equal to the plain one-hot on the card bit for bit, min_df to the order
of a sum, and the same bits on every run.

``segment2d._boundary_batch`` picks the route: engine "onehot" (the
pipelines' BOUNDARY_SEGMENT_ENGINE) on CUDA tensors launches this kernel,
and on CPU tensors runs the plain one-hot, as does ``_boundary_plain`` on
any device; engine "segment" stays the plain cross-check arm.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils import profiling
from . import launch

NAME = "boundary2d"


def _declare(lib: ctypes.CDLL) -> None:
    """Declare the library's C signatures."""
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.boundary2d_launch.argtypes = [i, p, p, p, ll, i, i, i, p, p, p, ll]
    lib.boundary2d_launch.restype = i
    lib.boundary2d_scratch_bytes.argtypes = [ll, i]
    lib.boundary2d_scratch_bytes.restype = ll
    lib.boundary2d_table_fits.argtypes = [i]
    lib.boundary2d_table_fits.restype = i
    lib.boundary2d_list_cap.argtypes = []
    lib.boundary2d_list_cap.restype = i


def _lib() -> ctypes.CDLL:
    """The built kernel library, loaded once, with its C signatures declared."""
    return launch.load(NAME, _declare, slots=False)


@profiling.spanned("fhmc.launch.b2d")
def boundary_pairs(lnpi: torch.Tensor, labels: torch.Tensor, max_labels: int) -> tuple:
    """Launch the boundary integrals of S states.

    lnpi   : f64[S, H, N]    surfaces
    labels : int32[S, H, N]  their labels (0 = background; labels above
                             max_labels take no part, where the plain
                             engines need every label <= max_labels)

    Returns (min_df, max_val): f64[S, L+1, L+1] (L = max_labels),
    symmetric, -DBL_MAX on the diagonal and at pairs with no shared
    boundary.  Runs on ``torch.cuda.current_stream()`` and does not
    synchronise.
    """
    dev = launch.check_tensors("boundary_pairs", {"lnpi": lnpi, "labels": labels}, {"labels": torch.int32})
    if lnpi.dim() != 3 or labels.shape != lnpi.shape:
        raise ValueError(f"boundary_pairs: need lnpi and labels [S, H, N] of one shape, got {tuple(lnpi.shape)} and {tuple(labels.shape)}")
    S, H, N = lnpi.shape
    L1 = int(max_labels) + 1
    if H * N >= 2**31 or not 1 <= L1 * L1 < 2**31:
        raise ValueError(f"boundary_pairs: H*N={H * N} and (max_labels+1)**2={L1 * L1} must stay below 2**31 (int32 indices), max_labels >= 0")
    index, stream = launch.device_stream(dev)
    lib = _lib()
    f64 = dict(dtype=torch.float64, device=dev)
    min_df, max_val = torch.empty((S, L1, L1), **f64), torch.empty((S, L1, L1), **f64)
    nb = lib.boundary2d_scratch_bytes(S, L1 - 1)
    scratch = torch.empty(nb, dtype=torch.uint8, device=dev) if nb else None
    launch.run(
        "boundary_pairs", "b2d", lib, lib.boundary2d_launch, index, stream, lnpi.data_ptr(), labels.data_ptr(), S, H, N, L1 - 1,
        min_df.data_ptr(), max_val.data_ptr(), None if scratch is None else scratch.data_ptr(), nb,
    )
    return min_df, max_val
