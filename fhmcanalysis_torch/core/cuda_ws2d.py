"""The 2-D watershed kernel (CUDA, Hopper) and its wrapper.

Replaces, on CUDA tensors, the plain ``segment2d._hillclimb_plain``, which
the JAX package runs as jnp operations on XLA (its ``core/segment2d.py``):
the tie detector's shifted copies and compares, the separable footprint
argmax and ceil(log2 HN) rounds of gathers, ~200 passes over [S, H, N]
tensors for S = 1,024 states of 96 x 385.  The kernel,
``csrc/watershed2d.cu``, reads each state's lnPI once in bands, keeps its
chain table in shared memory and writes its labels once; its header says
how.  Every output equals the plain function's bit for bit.

``segment2d.hillclimb_segment_batch`` picks the route: CUDA tensors with
one [H, N] mask for every state, of a shape the library's rule takes
(``takes``: a footprint of at most 441 cells, at most 65,536 cells a
state, a block within the shared memory a block may opt into), launch
this kernel; everything else runs the plain function.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils import profiling
from . import launch

NAME = "watershed2d"


def _declare(lib: ctypes.CDLL) -> None:
    """Declare the library's C signatures."""
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.watershed2d_launch.argtypes = [i, p, p, p, ll, i, i, i, i, i, p, p, p, p, p, p]
    lib.watershed2d_launch.restype = i
    lib.watershed2d_fits.argtypes = [i] * 5
    lib.watershed2d_fits.restype = i


def _lib() -> ctypes.CDLL:
    """The built kernel library, loaded once, with its C signatures declared."""
    return launch.load(NAME, _declare, slots=False)


def _radii(fp_shape) -> tuple:
    """(ry, rx), the footprint's half extents, as the plain function takes them."""
    return (int(fp_shape[0]) - 1) // 2, (int(fp_shape[1]) - 1) // 2


def takes(H: int, N: int, fp_shape, P: int) -> bool:
    """Whether the library's rule takes surfaces of H x N cells, this
    footprint and P label slots."""
    return bool(_lib().watershed2d_fits(H, N, *_radii(fp_shape), P))


@profiling.spanned("fhmc.launch.ws2d")
def watershed(lnpi: torch.Tensor, valid: torch.Tensor, fp_shape, P: int) -> dict:
    """Launch the watershed of S states.

    lnpi  : f64[S, H, N]   surfaces
    valid : bool[H, N]     every state's valid mask

    Returns the ``segment2d.hillclimb_segment_batch`` dict (labels,
    n_labels, peak_lnpi, peak_sat, peak_rc, elev_tie); a shape ``takes``
    refuses raises RuntimeError from the launch.  Runs on
    ``torch.cuda.current_stream()`` and does not synchronise.
    """
    if lnpi.dim() != 3 or valid.shape != lnpi.shape[1:]:
        raise ValueError(f"watershed: need lnpi [S, H, N] and valid [H, N], got {tuple(lnpi.shape)} and {tuple(valid.shape)}")
    S, H, N = lnpi.shape
    ry, rx = _radii(fp_shape)
    dev = launch.check_tensors("watershed", {"lnpi": lnpi, "valid": valid}, {"valid": torch.bool})
    index, stream = launch.device_stream(dev)
    lib = _lib()
    i32 = dict(dtype=torch.int32, device=dev)
    flag = dict(dtype=torch.bool, device=dev)
    out = {
        "labels": torch.empty((S, H, N), **i32),
        "n_labels": torch.empty((S,), **i32),
        "peak_lnpi": torch.empty((S, P), dtype=torch.float64, device=dev),
        "peak_sat": torch.empty((S,), **flag),
        "peak_rc": torch.empty((S, P, 2), **i32),
        "elev_tie": torch.empty((S,), **flag),
    }
    launch.run(
        "watershed", "ws2d", lib, lib.watershed2d_launch, index, stream, lnpi.data_ptr(), valid.data_ptr(), S, H, N, ry, rx, P,
        *(out[k].data_ptr() for k in ("labels", "n_labels", "peak_lnpi", "peak_sat", "peak_rc", "elev_tie")),
    )
    return out
