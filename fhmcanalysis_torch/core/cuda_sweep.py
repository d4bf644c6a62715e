"""The fused mu-sweep kernel (CUDA, Hopper) and its wrapper.

Replaces the TPU kernel ``fhmcanalysis_tpu/core/pallas_sweep.py``
(``_sweep_ds_pallas``), which ran the sweep in double-single f32 pairs
because the TPU has no f64.  The port computes in native f64: the kernel
source is ``csrc/sweep_thermo.cu``, G lanes per state point, with G
picked by ``lanes_per_point`` from N and the point count (K2 uses the
same rule).  On the card it is bound by f64 ``exp`` (one per bin and
point) and the serial segmentation logic, not by bytes: the composite's
rows are a few KB shared by every point.  The source's header says how the
layout answers that.

Capacities: every kernel has two builds by the phase slots a point holds,
``launch.CAPACITIES`` = (8, 64), and K1 two more by its per-phase sums (nspec
1-2 and 3-4).  ``launch.capacity`` and ``accumulators`` pick the smallest build
that holds a run, so max_phases <= 8 at nspec <= 2 runs the kernels'
first build, where all of their speed is; above 64 phase slots or 4
species the wrappers raise.  64 is the JAX package's own cap of its padded
device representation (``histogram/ntot.py``), and K2 and K3 keep its
nspec limit of 2.

The plain version of this kernel is ``segment.py`` + ``pipeline._point_thermo``;
nothing on the CUDA path calls it.  ``pipeline.mu_sweep_thermo`` picks
between the two by the tensors' device.
"""

from __future__ import annotations

import ctypes

from ..utils import profiling
from . import launch
from .launch import capacity, check_lanes, lanes_per_point, sm_count

NAME = "sweep_thermo"
MAX_NSPEC = 4  # K1's widest per-phase sums: 1 + nspec + 1 <= 6


def accumulators(nspec: int) -> int:
    """K1's per-phase sums for nspec species: the weight, each <N_i> and
    <U>, built for nspec <= 2 (4) and nspec <= 4 (6); ValueError above."""
    if not 1 <= nspec <= MAX_NSPEC:
        raise ValueError(f"nspec={nspec!r} outside K1's 1..{MAX_NSPEC}: its widest build sums {MAX_NSPEC + 2} key rows a phase "
                         "(the weight, each <N_i> and <U>)")
    return 4 if nspec <= 2 else MAX_NSPEC + 2


def _declare(lib: ctypes.CDLL) -> None:
    """Declare the library's C signatures and check its builds against this module."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.sweep_thermo_launch.argtypes = [i, p, i, i, i, p, p, p, p, p] + [i] * 7 + [p] * 11
    lib.sweep_thermo_launch.restype = i
    lib.sweep_thermo_static_smem.argtypes = [i, i]
    lib.sweep_thermo_static_smem.restype = i
    lib.sweep_thermo_max_nspec.argtypes = []
    lib.sweep_thermo_max_nspec.restype = i
    if lib.sweep_thermo_max_nspec() != MAX_NSPEC:
        raise RuntimeError("sweep_thermo.cu's widest build disagrees with cuda_sweep.MAX_NSPEC")


def _lib() -> ctypes.CDLL:
    """The built kernel library, loaded once, with its C signatures declared."""
    return launch.load(NAME, _declare)


@profiling.spanned("fhmc.launch.k1")
def sweep_thermo(lnpi, op, keys, volume, a, smooth: int, max_phases: int, props: bool = True, collect=None, *, _lanes=None) -> dict:
    """Launch the fused sweep kernel for B state points.

    lnpi, op : f64[N]        composite surface and order parameter
    keys     : f64[S+1, N]   <N_i> rows then <U> (segment.key_row_addresses)
    volume   : f64[]         box volume
    a        : f64[B]        per-point reweight coefficient beta*(mu - mu0)

    Returns the ``mu_sweep_thermo`` dict (fe, mask, left, right, n_phases,
    valid, and with props n_i, x_i [B,P,S], ntot, u, density [B,P]).  Runs
    on ``torch.cuda.current_stream()`` and does not synchronise.

    _lanes forces G, the lanes per point (tests and chip_smoke.py); by
    default ``lanes_per_point`` picks it.
    """
    if _lanes is not None:
        check_lanes(_lanes)
    dev = launch.check_tensors("sweep_thermo", {"lnpi": lnpi, "op": op, "keys": keys, "volume": volume, "a": a})
    if lnpi.dim() != 1 or op.shape != lnpi.shape or a.dim() != 1 or volume.numel() != 1:
        raise ValueError("sweep_thermo: need lnpi, op [N], a [B], scalar volume")
    N = lnpi.shape[0]
    S = keys.shape[0] - 1
    if keys.dim() != 2 or keys.shape[1] != N:
        raise ValueError(f"sweep_thermo: keys must be [S+1, N], got {tuple(keys.shape)}")
    kacc = accumulators(S)
    cap = capacity(max_phases)
    launch.check_scalars("sweep_thermo", N, smooth, collect)

    B, P = a.shape[0], max_phases
    index, stream = launch.device_stream(dev)
    G = lanes_per_point(N, B, sm_count(index), P) if _lanes is None else _lanes
    out = launch.sweep_outputs(B, P, S, props, dev)
    lib = _lib()
    launch.run(
        "sweep_thermo", "k1", lib, lib.sweep_thermo_launch, index, stream, G, cap, kacc,
        lnpi.data_ptr(), op.data_ptr(), keys.data_ptr(), volume.data_ptr(), a.data_ptr(),
        B, N, S, P, smooth, int(props), int(collect == "janus"), *launch.sweep_pointers(out),
    )
    return out
