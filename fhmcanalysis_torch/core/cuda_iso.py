"""The fused binary isopleth cell kernel K3 (CUDA, Hopper) and its wrapper.

Replaces the TPU kernel ``fhmcanalysis_tpu/core/pallas_iso.py``
(``_iso_ds_pallas``), which selected the two bracketing sources per cell
by one-hot sums, ran K2's whole per-lane body (grand-canonical averages
included) on each, mixed them and ran the thermo tail in double-single f32
pairs.  The port computes in native f64 and drops the averages (a constant
over the bins that the mix keeps constant and the tail, ``is_safe`` and
the edge flag cancel; ``binary/isopleth.py`` says why).  So K3 is K2's
x'/key' former (``csrc/extrap_rows.cuh``) run for the left and the right
source, the inverse-distance mix, and the tail K1 and K2 share
(``csrc/thermo_tail.cuh``) with a sink that keeps the most stable phase;
the source is ``csrc/iso_grid.cu`` (one cell's work in
``csrc/iso_cell.cuh``), G lanes per cell with G picked by
``lanes_per_cell``, and its header says what bounds it.  The build of 64
phase slots forms each cell's mixed surface x_m once per bin into an area
of shared memory where a block's area fits (``xm_bytes``), and on read
where it does not.

The plain version of this kernel is ``binary.isopleth.iso_grid_body``;
nothing on the CUDA path calls it.  ``binary.isopleth.iso_grid`` picks
between the two by the tensors' device.

Layouts (built by ``binary.isopleth._iso_prologue``; W sources, nspec 2):
  lnpi, op [W, N]        each source's surface and order parameter
  xrows    [W, R, N]     pipeline._mb_rows x-rows (R = 2, or 5 at order 2)
  krows    [W, KG, 3, N] its key-row groups (KG = 3, or 6 at order 2)
  a, edge  [W, NX]       beta_ref (mu_1 - mu_ref) and the edge flag per source and column
  mu       [NX]          mu_1 per column
  lr, wts  [NY, 2]       bracketing sources (int32, each in [0, W): the
                         prologue checks it on the host, a check here
                         would wait for the device) and weights per row
  tg       [NY, 2, T]    target scalars per row and side (pipeline._mb_targets)
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..utils import profiling
from .cuda_mb import n_groups, n_xrows
from .cuda_sweep import CAPACITIES, MAX_PHASES, THREADS, capacity, check_capacities, check_lanes, slot_bytes, sm_count, stages_rows  # noqa: F401  (MAX_PHASES: the kernel's, as cuda_sweep's)

NAME = "iso_grid"
S = 2  # the isopleth class takes binary mixtures only
MAX_STAGED = 32  # sources a block may stage (csrc/iso_grid.cu)
# static shared bytes of K3's staged-source list (csrc/iso_grid.cu
# LIST_BYTES): 33 ints, rounded up to 16 as ptxas rounds the static area
LIST_BYTES = (4 * (MAX_STAGED + 1) + 15) // 16 * 16
# shared memory a block may opt in to on Hopper, static and dynamic
# together (csrc/iso_grid.cu SMEM_OPTIN): 227 KB
SMEM_OPTIN = 232_448
# G = 1 from min(G1_PER_BIN * N, G1_PER_SM_CAP) cells per SM in the first
# build and min(G1_PER_BIN_WIDE * N, G1_PER_SM_CAP) in the build of 64
# slots: fitted on one H100 SXM (132 SMs) to K3's layout lines in
# chip_smoke.py (PERF.md)
G1_PER_BIN = 3
G1_PER_BIN_WIDE = 1
G1_PER_SM_CAP = 1024


def g1_switch(N: int, n_sm: int, max_phases: int = 8) -> int:
    """The least cell count at which K3 runs one cell per lane, for N bins
    and max_phases phase slots on a card of n_sm SMs.  The build of 64
    slots keeps each cell's x_m in shared memory, which at G = 32 spares
    its 32 lanes re-forming it at every step, so G = 32 holds out longer
    per bin: its layout lines crossed between 16 and 32 cells per SM at N
    = 31 (min(N, .) = 31) and between 768 and 1,024 at N = 1400, where
    G = 1 forms x_m on read (the area does not fit)."""
    per_bin = G1_PER_BIN if capacity(max_phases) == CAPACITIES[0] else G1_PER_BIN_WIDE
    return n_sm * min(per_bin * N, G1_PER_SM_CAP)


def lanes_per_cell(N: int, B: int, n_sm: int, max_phases: int = 8) -> int:
    """G, the lanes of a warp that K3 gives one cell, for B cells of N bins
    and max_phases phase slots on a card of n_sm SMs.

    K1's and K2's rule in form (``cuda_sweep.lanes_per_point``: G = 1 needs
    enough cells in flight to hide one lane walking a cell's N bins) with
    constants of K3's own: a cell forms two sources' x' and their mix at
    every read, and its G = 1 layout holds 2 blocks (512 cells) per SM, so
    on one H100 its layout lines crossed later than K1's, and G = 1 won
    from about 3N cells per SM at N = 31 and from about 1,024 (two such
    waves) at N = 1400.  K3 is not bound to K1's bits (K2 is), so it may
    switch elsewhere; its build of 64 phase slots switches from about N
    cells per SM (``g1_switch``).
    """
    return 1 if B >= g1_switch(N, n_sm, max_phases) else 32


def _declare(lib: ctypes.CDLL) -> None:
    """Declare the library's C signatures and check its builds against this module."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.iso_grid_launch.argtypes = [i, p, i, i, i] + [p] * 11 + [i] * 10 + [ctypes.c_double] + [p] * 5
    lib.iso_grid_launch.restype = i
    for fn in (lib.iso_grid_staged_sources, lib.iso_grid_xm_bytes):
        fn.argtypes = [i] * 8
        fn.restype = i
    lib.iso_grid_error_string.argtypes = [i]
    lib.iso_grid_error_string.restype = ctypes.c_char_p
    check_capacities(lib, NAME)


def _lib() -> ctypes.CDLL:
    """The built kernel library, loaded once, with its C signatures declared."""
    return _build.load(NAME, _declare)


def _source_bytes(N: int, order: int) -> int:
    """Bytes of one source's rows: lnpi, op, xrows, krows."""
    return (2 + n_xrows(S, order) + (S + 1) * n_groups(S, order, False)) * N * 8


def staged_sources(G: int, W: int, NX: int, NY: int, N: int, order: int, max_phases: int = 8) -> int:
    """Sources a block of K3 stages in shared memory at G lanes per cell
    on this grid (0: its rows stay in global memory): a block's THREADS/G
    cells span at most (THREADS/G - 1) // NX + 2 rows of 2 sources each,
    staged where they fit beside the build's index slots and the list of
    staged sources (cuda_sweep.stages_rows).  csrc/iso_grid.cu decides;
    this counts it the same way on the host (a GPU test holds the two
    equal)."""
    if G >= 32:
        return 0
    span = (THREADS // G - 1) // NX + 2
    k = min(2 * min(span, NY), W)
    nbytes = k * _source_bytes(N, order) + LIST_BYTES
    return k if k <= MAX_STAGED and stages_rows(G, capacity(max_phases), nbytes) else 0


def xm_bytes(G: int, W: int, NX: int, NY: int, N: int, order: int, max_phases: int = 8) -> int:
    """Bytes of the x_m area a block of K3 reserves in dynamic shared
    memory at G lanes per cell on this grid, beside its staged rows (0:
    x_m is formed on read): the build of 64 phase slots keeps THREADS/G
    cells of N doubles where the block's static slots and list, its staged
    rows and the area fit SMEM_OPTIN; the first build has no area.
    csrc/iso_grid.cu decides; this counts it the same way on the host (a
    GPU test holds the two equal)."""
    cap = capacity(max_phases)
    if cap == CAPACITIES[0]:
        return 0
    area = THREADS // G * N * 8
    fixed = slot_bytes(G, cap) + (LIST_BYTES if G < 32 else 0) + staged_sources(G, W, NX, NY, N, order, max_phases) * _source_bytes(N, order)
    return area if fixed + area <= SMEM_OPTIN else 0


@profiling.spanned("fhmc.launch.k3")
def iso_grid(lnpi, op, xrows, krows, a, edge, mu, lr, wts, tg, volume, smooth: int, max_phases: int, order: int, cutoff: float, collect=None, *, _lanes=None, _xm=None):
    """Launch K3 for the NY x NX cells (mu[ix], row iy), b = iy * NX + ix.

    Tensors as in the module docstring.  Returns (z, density, fe, ok,
    fail_code), each [NY, NX] (f64, f64, f64, bool, int32).  Runs on
    ``torch.cuda.current_stream()`` and does not synchronise.

    _lanes forces G, the lanes per cell, and _xm (True / False) the x_m
    area of the build of 64 slots on or off (tests and
    tools/k3_xm_share.py); by
    default ``lanes_per_cell`` picks G and ``xm_bytes`` the area.  An area
    past what the card grants a block fails the launch, which raises.
    """
    if _lanes is not None:
        check_lanes(_lanes)
    if _xm not in (None, True, False):
        raise ValueError(f"iso_grid: _xm must be None, True or False, got {_xm!r}")
    tensors = {"lnpi": lnpi, "op": op, "xrows": xrows, "krows": krows, "a": a, "edge": edge, "mu": mu, "lr": lr, "wts": wts, "tg": tg, "volume": volume}
    for name, t in tensors.items():
        if t is None or not t.is_cuda:
            raise ValueError(f"iso_grid: {name} is {'missing' if t is None else t.device}; the CUDA kernel needs CUDA tensors (engine='torch' runs the plain version)")
        want = torch.bool if name == "edge" else torch.int32 if name == "lr" else torch.float64
        if t.dtype != want:
            raise TypeError(f"iso_grid: {name} must be {want}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"iso_grid: {name} must be contiguous")
        if t.device != lnpi.device:
            raise ValueError(f"iso_grid: {name} is on {t.device}, lnpi on {lnpi.device}")
    if order not in (1, 2):
        raise ValueError(f"iso_grid: the kernel implements orders 1-2, got {order}")
    if lnpi.dim() != 2 or op.shape != lnpi.shape or volume.numel() != 1:
        raise ValueError("iso_grid: need lnpi, op [W, N] and a scalar volume")
    W, N = lnpi.shape
    R = T = n_xrows(S, order)  # one target scalar per x-row
    KG = n_groups(S, order, False)
    if not 1 <= N < 2**31 - 1 or W < 1:
        raise ValueError(f"iso_grid: need 1 <= N < 2**31-1 and W >= 1, got W={W}, N={N}")
    if xrows.shape != (W, R, N) or krows.shape != (W, KG, S + 1, N):
        raise ValueError(f"iso_grid: xrows must be [{W}, {R}, {N}] and krows [{W}, {KG}, {S + 1}, {N}], got {tuple(xrows.shape)}, {tuple(krows.shape)}")
    NX, NY = mu.shape[0] if mu.dim() == 1 else -1, lr.shape[0]
    if NX < 0 or a.shape != (W, NX) or edge.shape != (W, NX):
        raise ValueError(f"iso_grid: need mu [NX] and a, edge [{W}, NX]")
    if lr.shape != (NY, 2) or wts.shape != (NY, 2) or tg.shape != (NY, 2, T):
        raise ValueError(f"iso_grid: need lr, wts [NY, 2] and tg [NY, 2, {T}]")
    cap = capacity(max_phases)
    if _xm and cap == CAPACITIES[0]:
        raise ValueError(f"iso_grid: the x_m area is the build of {CAPACITIES[-1]} slots'; max_phases={max_phases} runs the first build")
    if smooth < 1:
        raise ValueError("smooth must be >= 1 to find relative extrema (scipy argrelextrema rejects order 0 too)")
    if collect not in (None, "janus"):
        raise NotImplementedError(f"iso_grid: the kernel implements collect None and 'janus', not {collect!r}")
    if NX * NY >= 2**31:
        raise ValueError(f"iso_grid: {NY} x {NX} cells exceed the kernel's int32 grid")

    dev = lnpi.device
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    G = lanes_per_cell(N, NX * NY, sm_count(index), max_phases) if _lanes is None else _lanes
    out = {
        "z": torch.empty((NY, NX), dtype=torch.float64, device=dev),
        "rho": torch.empty((NY, NX), dtype=torch.float64, device=dev),
        "fe": torch.empty((NY, NX), dtype=torch.float64, device=dev),
        "ok": torch.empty((NY, NX), dtype=torch.bool, device=dev),
        "code": torch.empty((NY, NX), dtype=torch.int32, device=dev),
    }
    lib = _lib()
    rc = lib.iso_grid_launch(
        index,
        torch.cuda.current_stream(dev).cuda_stream,
        G,
        cap,
        -1 if _xm is None else int(_xm),
        *(t.data_ptr() for t in tensors.values()),
        W, NX, NY, N, R, KG, max_phases, smooth, order, int(collect == "janus"), float(cutoff),
        *(t.data_ptr() for t in out.values()),
    )
    if rc != 0:
        raise RuntimeError(f"iso_grid kernel launch failed: {lib.iso_grid_error_string(rc).decode()} ({rc})")
    profiling.add("launches.k3")
    return out["z"], out["rho"], out["fe"], out["ok"], out["code"]
