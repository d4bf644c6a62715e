"""The seam between the port's Python and its CUDA libraries.

``cuda_sweep`` (K1), ``cuda_mb`` (K2 and its row former), ``cuda_iso``
(K3), ``cuda_b2d`` (the 2-D boundary integrals) and ``cuda_ws2d`` (the
2-D watershed) each declare their library's launch signature, check the
shapes of their arguments and make their launch call; what they share is
here: the builds' common facts (their phase-slot capacities and layouts,
K1's and K2's layout rule), loading a library, the check of the tensors a
kernel reads, the scalar checks, the allocation of the sweep's outputs
and the launch itself with its error path and counter.  The shared-memory
layout rules live in the CUDA sources alone (``csrc/thermo_tail.cuh``,
``mb_xarea.cuh``, ``iso_cell.cuh``, ``boundary2d.cu``,
``watershed2d.cu``); a wrapper that needs one asks its loaded library.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from ..utils import profiling

CAPACITIES = (8, 64)  # phase slots of the kernels' builds: csrc/thermo_tail.cuh SMALL, WIDE
MAX_PHASES = CAPACITIES[-1]  # the widest build's per-point arrays
LANES = (1, 32)  # the layouts the kernels build (csrc/thermo_tail.cuh is a template on any power of two dividing 32)
# G = 1 from min(N, G1_PER_SM_CAP) points per SM up: fitted on one H100 SXM
# (132 SMs) to the layout lines chip_smoke.py prints (PERF.md).  The builds
# of 64 phase slots switch at min(N, G1_PER_SM_CAP_WIDE), fitted to phase
# 5f's 116 wide layout lines: one warp per point won up to 128 points per
# SM at N = 573 and one lane per point from 256 (PERF.md)
G1_PER_SM_CAP = 384
G1_PER_SM_CAP_WIDE = 256
# the sweep's outputs in the order the K1 and K2 launches take their pointers
# (the last five with props only)
SWEEP_OUTPUTS = ("fe", "left", "right", "mask", "n_phases", "valid", "n_i", "x_i", "ntot", "u", "density")


def capacity(max_phases: int) -> int:
    """The phase slots of the smallest build of K1, K2 and K3 that holds
    max_phases; ValueError above the widest."""
    if not 1 <= max_phases <= MAX_PHASES:
        raise ValueError(f"max_phases={max_phases!r} outside the kernels' 1..{MAX_PHASES}: their widest build holds {MAX_PHASES} phase "
                         "slots a point, the JAX package's cap of its padded device representation")
    return next(c for c in CAPACITIES if max_phases <= c)


def check_lanes(G) -> int:
    """G itself, or ValueError for a layout the kernels do not build."""
    if isinstance(G, bool) or not isinstance(G, int) or G not in LANES:
        raise ValueError(f"_lanes={G!r}: lanes per point must be a power of two dividing 32 that the kernels build, one of {LANES}")
    return G


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device `index`."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def lanes_per_point(N: int, B: int, n_sm: int, max_phases: int = 8) -> int:
    """G, the lanes of a warp that K1 and K2 give one state point, for B
    points of N bins and max_phases phase slots on a card of n_sm SMs.

    G = 1 (a point per lane, its bins walked serially, 32 points to a warp
    instruction) runs the per-point segmentation logic once instead of on
    32 lanes, so it has the higher throughput at every N; but one lane
    walks all N bins, so a point takes ~N/32 times longer than at G = 32
    (one point per warp), and G = 1 wins only once the card holds enough
    points to hide that.  On one H100 the two crossed near N points per
    SM at small N and near 384 per SM from N ~ 400 up; chip_smoke.py
    times both layouts at half and twice the switch.  K1 and K2 share
    this rule so that K2 at identity targets (A = 1, so K1's B) returns
    K1's output bit for bit: the sums' order depends on G (and both take
    their phase-slot build from max_phases alone).  The builds of 64 phase slots
    (max_phases > 8) switch from min(N, G1_PER_SM_CAP_WIDE) points per SM.
    """
    per_sm = G1_PER_SM_CAP if capacity(max_phases) == CAPACITIES[0] else G1_PER_SM_CAP_WIDE
    return 1 if B >= n_sm * min(N, per_sm) else 32


@functools.lru_cache(maxsize=None)
def load(name: str, declare, slots: bool = True) -> ctypes.CDLL:
    """The library of ``csrc/<name>.cu``, built and loaded once (``_build.load``),
    with ``<name>_error_string`` declared, its widest build checked against
    MAX_PHASES (where it has builds by phase slots: `slots`), and then
    ``declare(lib)`` run on it (its own signatures)."""

    def declare_all(lib: ctypes.CDLL) -> None:
        lib.error_string = getattr(lib, f"{name}_error_string")
        lib.error_string.argtypes, lib.error_string.restype = [ctypes.c_int], ctypes.c_char_p
        if slots:
            top = getattr(lib, f"{name}_max_phases")
            top.argtypes, top.restype = [], ctypes.c_int
            if top() != MAX_PHASES:
                raise RuntimeError(f"{name}: the library's widest build holds {top()} phase slots, launch.MAX_PHASES says {MAX_PHASES}")
        declare(lib)

    return _build.load(name, declare_all)


def check_tensors(who: str, tensors: dict, dtypes: dict | None = None, contiguous: bool = True) -> torch.device:
    """Raise unless every tensor of `tensors` (name -> tensor) is present,
    on a CUDA device, of its dtype (``dtypes[name]``, float64 by default),
    contiguous (where `contiguous`) and on the device of the first; return
    that device."""
    dtypes = dtypes or {}
    first, dev = next(iter(tensors)), None
    for name, t in tensors.items():
        if t is None or not t.is_cuda:
            where = "missing" if t is None else f"on {t.device}"
            raise ValueError(f"{who}: {name} is {where}; the CUDA kernel needs CUDA tensors (engine='torch' runs the plain version)")
        want = dtypes.get(name, torch.float64)
        if t.dtype != want:
            raise TypeError(f"{who}: {name} must be {str(want).removeprefix('torch.')}, got {t.dtype}")
        if contiguous and not t.is_contiguous():
            raise ValueError(f"{who}: {name} must be contiguous")
        if dev is None:
            dev = t.device
        if t.device != dev:
            raise ValueError(f"{who}: {name} is on {t.device}, {first} on {dev}")
    return dev


def check_scalars(who: str, N: int, smooth: int, collect) -> None:
    """Raise for a bin count the kernels' int32 indices cannot take, a
    smooth below 1 or a collect the kernels do not implement."""
    if not 1 <= N < 2**31 - 1:
        raise ValueError(f"{who}: N={N} outside 1 <= N < 2**31-1")
    if smooth < 1:
        raise ValueError("smooth must be >= 1 to find relative extrema (scipy argrelextrema rejects order 0 too)")
    if collect not in (None, "janus"):
        raise NotImplementedError(f"{who}: the kernel implements collect None and 'janus', not {collect!r}")


def device_stream(dev: torch.device) -> tuple:
    """(index, stream): dev's CUDA device index (the current device for a
    bare "cuda") and the handle of its current stream, on which every
    launch runs."""
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    return index, torch.cuda.current_stream(dev).cuda_stream


def sweep_outputs(B: int, P: int, S: int, props: bool, dev: torch.device) -> dict:
    """Uninitialised outputs of a sweep of B points and P phase slots (the
    mu_sweep_thermo dict; n_i, x_i, ntot, u, density with props only)."""
    f64 = dict(dtype=torch.float64, device=dev)
    out = {
        "fe": torch.empty((B, P), **f64),
        "mask": torch.empty((B, P), dtype=torch.bool, device=dev),
        "left": torch.empty((B, P), dtype=torch.int32, device=dev),
        "right": torch.empty((B, P), dtype=torch.int32, device=dev),
        "n_phases": torch.empty((B,), dtype=torch.int32, device=dev),
        "valid": torch.empty((B,), dtype=torch.bool, device=dev),
    }
    if props:
        out.update(
            n_i=torch.empty((B, P, S), **f64),
            x_i=torch.empty((B, P, S), **f64),
            ntot=torch.empty((B, P), **f64),
            u=torch.empty((B, P), **f64),
            density=torch.empty((B, P), **f64),
        )
    return out


def sweep_pointers(out: dict) -> list:
    """out's data pointers in SWEEP_OUTPUTS order, None for those left out."""
    return [out[k].data_ptr() if k in out else None for k in SWEEP_OUTPUTS]


def run(who: str, counter: str, lib: ctypes.CDLL, fn, *args) -> None:
    """Call the launch function fn of lib with args; a nonzero return (a
    CUDA error code) raises RuntimeError with its text, else counts one
    ``launches.<counter>``."""
    rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"{who} kernel launch failed: {lib.error_string(rc).decode()} ({rc})")
    profiling.add(f"launches.{counter}")
