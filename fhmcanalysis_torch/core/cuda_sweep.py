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
``CAPACITIES`` = (8, 64), and K1 two more by its per-phase sums (nspec
1-2 and 3-4).  ``capacity`` and ``accumulators`` pick the smallest build
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
import functools

import torch

from .. import _build
from ..utils import profiling

NAME = "sweep_thermo"
CAPACITIES = (8, 64)  # phase slots of the kernels' builds: csrc/thermo_tail.cuh SMALL, WIDE
MAX_PHASES = CAPACITIES[-1]  # the widest build's per-point arrays
MAX_NSPEC = 4  # K1's widest per-phase sums: 1 + nspec + 1 <= 6
LANES = (1, 32)  # the layouts the kernels build (csrc/thermo_tail.cuh is a template on any power of two dividing 32)
THREADS = 256  # threads per block, every kernel and layout (thermo_tail.cuh)
STATIC_SMEM = 48 * 1024  # shared memory a block gets without opting in
# G = 1 from min(N, G1_PER_SM_CAP) points per SM up: fitted on one H100 SXM
# (132 SMs) to the layout lines chip_smoke.py prints (PERF.md).  The builds
# of 64 phase slots switch at min(N, G1_PER_SM_CAP_WIDE), fitted to phase
# 5f's 116 wide layout lines: one warp per point won up to 128 points per
# SM at N = 573 and one lane per point from 256 (PERF.md)
G1_PER_SM_CAP = 384
G1_PER_SM_CAP_WIDE = 256


def capacity(max_phases: int) -> int:
    """The phase slots of the smallest build of K1, K2 and K3 that holds
    max_phases; ValueError above the widest."""
    if not 1 <= max_phases <= MAX_PHASES:
        raise ValueError(f"max_phases={max_phases!r} outside the kernels' 1..{MAX_PHASES}: their widest build holds {MAX_PHASES} phase "
                         "slots a point, the JAX package's cap of its padded device representation")
    return next(c for c in CAPACITIES if max_phases <= c)


def accumulators(nspec: int) -> int:
    """K1's per-phase sums for nspec species: the weight, each <N_i> and
    <U>, built for nspec <= 2 (4) and nspec <= 4 (6); ValueError above."""
    if not 1 <= nspec <= MAX_NSPEC:
        raise ValueError(f"nspec={nspec!r} outside K1's 1..{MAX_NSPEC}: its widest build sums {MAX_NSPEC + 2} key rows a phase "
                         "(the weight, each <N_i> and <U>)")
    return 4 if nspec <= 2 else MAX_NSPEC + 2


def slot_bytes(G: int, cap: int) -> int:
    """Shared-memory bytes of a block's index slots (cap maxima and cap+1
    minima a point, THREADS/G points), as csrc/thermo_tail.cuh slot_bytes
    counts them: the wide build at G < 32 keeps them in each lane's local
    memory instead (132 KB a block would need opting in), so 0."""
    shared = G == 32 or cap <= CAPACITIES[0]
    return (2 * cap + 1) * 4 * (THREADS // G) if shared else 0


def row_tile_bytes(G: int, cap: int) -> int:
    """Shared-memory bytes of K1's and K2's row tile, as
    csrc/thermo_tail.cuh row_tile_bytes counts them: in the wide build at
    G = 1 each warp writes its points' rows through 32 bytes a lane
    (1 KB a warp), so that every store covers consecutive elements of a
    row; 0 in every other build."""
    return (THREADS // 32) * 32 * 32 if G == 1 and cap > CAPACITIES[0] else 0


def shared_bytes(G: int, cap: int) -> int:
    """Static shared bytes of a block of K1 or K2: the index slots and the
    row tile (chip_smoke.py holds them to the ptxas lines; K3 reserves its
    slots and its staged-source list instead, cuda_iso.LIST_BYTES)."""
    return slot_bytes(G, cap) + row_tile_bytes(G, cap)


def stages_rows(G: int, cap: int, nbytes: int) -> bool:
    """Whether a block of K3 stages nbytes of mu-independent rows in
    shared memory beside its index slots (csrc/thermo_tail.cuh
    stages_rows; K1 and K2 also count their row tile there)."""
    return G < 32 and nbytes + slot_bytes(G, cap) <= STATIC_SMEM


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
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device `index`."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def check_lanes(G) -> int:
    """G itself, or ValueError for a layout the kernels do not build."""
    if isinstance(G, bool) or not isinstance(G, int) or G not in LANES:
        raise ValueError(f"_lanes={G!r}: lanes per point must be a power of two dividing 32 that the kernels build, one of {LANES}")
    return G


def _declare(lib: ctypes.CDLL) -> None:
    """Declare the library's C signatures and check its builds against this module."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.sweep_thermo_launch.argtypes = [i, p, i, i, i, p, p, p, p, p] + [i] * 7 + [p] * 11
    lib.sweep_thermo_launch.restype = i
    lib.sweep_thermo_error_string.argtypes = [i]
    lib.sweep_thermo_error_string.restype = ctypes.c_char_p
    check_capacities(lib, NAME)
    lib.sweep_thermo_max_nspec.argtypes = []
    lib.sweep_thermo_max_nspec.restype = i
    if lib.sweep_thermo_max_nspec() != MAX_NSPEC:
        raise RuntimeError("sweep_thermo.cu's widest build disagrees with cuda_sweep.MAX_NSPEC")


def _lib() -> ctypes.CDLL:
    """The built kernel library, loaded once, with its C signatures declared."""
    return _build.load(NAME, _declare)


def check_capacities(lib, name: str) -> None:
    """Raise unless a kernel library's <name>_max_phases agrees with
    MAX_PHASES (chip_smoke.py holds slot_bytes to the ptxas lines)."""
    top = getattr(lib, f"{name}_max_phases")
    top.argtypes, top.restype = [], ctypes.c_int
    if top() != MAX_PHASES:
        raise RuntimeError(f"{name}: the library's widest build holds {top()} phase slots, cuda_sweep.MAX_PHASES says {MAX_PHASES}")


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
    tensors = {"lnpi": lnpi, "op": op, "keys": keys, "volume": volume, "a": a}
    for name, t in tensors.items():
        if not t.is_cuda:
            raise ValueError(f"sweep_thermo: {name} is on {t.device}; the CUDA kernel needs CUDA tensors (engine='torch' runs the plain version)")
        if t.dtype != torch.float64:
            raise TypeError(f"sweep_thermo: {name} must be float64, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"sweep_thermo: {name} must be contiguous")
        if t.device != lnpi.device:
            raise ValueError(f"sweep_thermo: {name} is on {t.device}, lnpi on {lnpi.device}")
    if lnpi.dim() != 1 or op.shape != lnpi.shape or a.dim() != 1 or volume.numel() != 1:
        raise ValueError("sweep_thermo: need lnpi, op [N], a [B], scalar volume")
    N = lnpi.shape[0]
    S = keys.shape[0] - 1
    if keys.dim() != 2 or keys.shape[1] != N:
        raise ValueError(f"sweep_thermo: keys must be [S+1, N], got {tuple(keys.shape)}")
    kacc = accumulators(S)
    cap = capacity(max_phases)
    if smooth < 1:
        raise ValueError("smooth must be >= 1 to find relative extrema (scipy argrelextrema rejects order 0 too)")
    if N < 1 or N >= 2**31 - 1:
        raise ValueError(f"sweep_thermo: N={N} out of range")
    if collect not in (None, "janus"):
        raise NotImplementedError(f"sweep_thermo: the kernel implements collect None and 'janus', not {collect!r}")

    B, P, dev = a.shape[0], max_phases, lnpi.device
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    G = lanes_per_point(N, B, sm_count(index), P) if _lanes is None else _lanes
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
    ptr = {k: v.data_ptr() for k, v in out.items()}
    lib = _lib()
    rc = lib.sweep_thermo_launch(
        index,
        torch.cuda.current_stream(dev).cuda_stream,
        G,
        cap,
        kacc,
        lnpi.data_ptr(),
        op.data_ptr(),
        keys.data_ptr(),
        volume.data_ptr(),
        a.data_ptr(),
        B,
        N,
        S,
        P,
        smooth,
        int(props),
        int(collect == "janus"),
        ptr["fe"],
        ptr["left"],
        ptr["right"],
        ptr["mask"],
        ptr["n_phases"],
        ptr["valid"],
        *(ptr.get(k) for k in ("n_i", "x_i", "ntot", "u", "density")),
    )
    if rc != 0:
        raise RuntimeError(f"sweep_thermo kernel launch failed: {lib.sweep_thermo_error_string(rc).decode()} ({rc})")
    profiling.add("launches.k1")
    return out
