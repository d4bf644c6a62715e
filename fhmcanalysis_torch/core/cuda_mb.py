"""The fused (mu_1, beta, dMu) extrapolating-sweep kernel K2 (CUDA, Hopper)
and its wrapper.

Replaces the TPU kernel ``fhmcanalysis_tpu/core/pallas_mb.py``
(``_mb_ds_pallas``), which ran reweight -> grand-canonical averages ->
Taylor apply -> thermo per point in double-single f32 pairs.  The port
computes in native f64 and drops the per-point grand-canonical averages:
they shift lnPI' by a constant the thermo tail cancels (pipeline.py says
why).  So K2 is K1's tail (``csrc/thermo_tail.cuh``) fed a richer x'(i)
and richer key rows, both recomputed from a few mu-independent rows; the
source is ``csrc/mb_sweep_thermo.cu``, G lanes per point with K1's rule
(``cuda_sweep.lanes_per_point``), and its header says what bounds it.
Where ``xarea_fits`` holds (G = 1 and N up to 33-36) each point's x' is
formed once a bin into an area of shared memory, and elsewhere at every
read of it; counter ``launches.k2_xarea`` counts the launches that take the
area.

The plain version of this kernel is ``pipeline.mu_beta_sweep_body``;
nothing on the CUDA path calls it.  ``pipeline.mu_beta_sweep_thermo``
picks between the two by the tensors' device.

Row layouts:
  xrows [R, N]     r1, mq (nspec 2), then at order 2: h00, h01, h11 (nspec 2)
  krows [G, S+1, N] key, sgB, sgM (nspec 2), then at order 2 unless
                    first_order_mom: sgB2, sgX, sgM2 (nspec 2)
  tg    [A, T]     dB, dd (nspec 2), then at order 2: dB^2, 2 dB dd, dd^2

The rows are written by the row former (``mb_rows``, ``csrc/mb_rows.cuh``,
built into this library): one launch, one thread per bin, over a table of
moment addresses that ``rows_table`` resolves on the host.  Its plain
version is ``pipeline._mb_rows``, which it equals bit for bit; CPU tensors
and ``engine="torch"`` run that.  ``tg`` is ``pipeline._mb_targets``'.

Two modes: the product of the M mu values and the A targets, and with
``tix`` the paired mode, one target per mu (the coexistence solver's,
``core/solve.py``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from .. import _build
from ..utils import profiling
from .derivs import check_order, xni_addr, zero_power
from .moments import mom_prod
from .cuda_sweep import CAPACITIES, LANES, MAX_PHASES, capacity, check_capacities, check_lanes, lanes_per_point, sm_count  # noqa: F401  (MAX_PHASES: the kernel's, as cuda_sweep's)

NAME = "mb_sweep_thermo"
# K2's x' area (csrc/mb_sweep_thermo.cu): shared memory of one Hopper SM,
# what the runtime keeps of it for each resident block, the points of a
# block of the area's build, the blocks an SM it is made for, and the most
# rows a block stages beside the area (lnpi, op, 5 x-rows, 18 key rows:
# nspec 2, order 2, props)
SMEM_SM = 233_472
SMEM_RESERVED = 1_024
XAREA_THREADS = 64
XAREA_MIN_BLOCKS = 8
XAREA_ROWS = 25


def n_xrows(S: int, order: int) -> int:
    """Rows of xrows, and columns of tg: each x' row has its target scalar."""
    return S + (0 if order < 2 else (1 if S == 1 else 3))


def n_groups(S: int, order: int, first_order_mom: bool) -> int:
    return 1 + S + (0 if order < 2 or first_order_mom else (1 if S == 1 else 3))


def xarea_bytes(G: int, N: int) -> int:
    """Bytes of K2's x' area a block: N doubles for each of its points."""
    return XAREA_THREADS // G * N * 8


def xarea_fits(G: int, cap: int, N: int) -> bool:
    """Whether K2 at G lanes a point, in the build of cap phase slots,
    forms each point's x' once a bin into an area of shared memory (else
    on every read): at G = 1 where a block's area, its index slots and row
    tile and the most rows it stages (XAREA_ROWS) leave the
    XAREA_MIN_BLOCKS blocks an SM its build is made for.
    csrc/mb_sweep_thermo.cu decides; this counts it the same way on the
    host (the library is held to it as it loads, and a GPU test over every
    N)."""
    if G != 1:
        return False
    block = xarea_bytes(G, N) + XAREA_ROWS * N * 8 + xarea_static_bytes(cap) + SMEM_RESERVED
    return XAREA_MIN_BLOCKS * block <= SMEM_SM


def xarea_static_bytes(cap: int) -> int:
    """Static shared bytes of a block of K2's build with the x' area, of
    XAREA_THREADS points: its index slots in the build of 8 slots, its row
    tile (1 KB a warp) in that of 64 (chip_smoke.py holds them to the
    ptxas lines)."""
    T = XAREA_THREADS
    return (2 * cap + 1) * 4 * T if cap <= CAPACITIES[0] else T // 32 * 1024


def xarea_limit(G: int, cap: int) -> int:
    """The largest N that xarea_fits admits (0 if none)."""
    n = 0
    while xarea_fits(G, cap, n + 1):
        n += 1
    return n


def _declare(lib: ctypes.CDLL) -> None:
    """Declare the library's C signatures and check its builds against this module."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.mb_sweep_thermo_launch.argtypes = [i, p, i, i, i] + [p] * 9 + [i] * 10 + [p] * 11
    lib.mb_sweep_thermo_launch.restype = i
    lib.mb_sweep_thermo_xarea_fits.argtypes = [i] * 3
    lib.mb_sweep_thermo_xarea_fits.restype = i
    lib.mb_sweep_thermo_blocks_per_sm.argtypes = [i] * 10
    lib.mb_sweep_thermo_blocks_per_sm.restype = i
    for G in LANES:
        for cap in CAPACITIES:
            top = xarea_limit(G, cap)
            for N in {1, 31, top, top + 1, 573}:
                if bool(lib.mb_sweep_thermo_xarea_fits(G, cap, N)) != xarea_fits(G, cap, N):
                    raise RuntimeError(f"{NAME}: the library's x' area rule disagrees with cuda_mb.xarea_fits at G={G}, cap={cap}, N={N}")
    lib.mb_sweep_thermo_error_string.argtypes = [i]
    lib.mb_sweep_thermo_error_string.restype = ctypes.c_char_p
    lib.mb_rows_launch.argtypes = [i, p, ctypes.POINTER(ctypes.c_int)] + [p] * 6 + [i]
    lib.mb_rows_launch.restype = i
    lib.mb_rows_table_ints.restype = i
    if lib.mb_rows_table_ints() != TABLE_INTS:
        raise RuntimeError(f"{NAME}: the library's row-former table has {lib.mb_rows_table_ints()} ints, this module writes {TABLE_INTS}")
    check_capacities(lib, NAME)


def _lib() -> ctypes.CDLL:
    """The built kernel library, loaded once, with its C signatures declared."""
    return _build.load(NAME, _declare)


def _check_tix(tix, mu, A: int, dev) -> None:
    """tix is an int32 [M] CUDA tensor beside mu with every entry in
    [0, A).  The range is read from the card once per tensor and again after
    an in-place write to it (its version counter), so a caller that
    launches with one tix at every step, as the coexistence solver does,
    waits for the card once.  This check gives the early error; the
    kernel itself marks a point whose tix lies outside [0, A) invalid
    (valid False, no phase, NaN floats), so a write the version counter
    misses (through ``.data`` or a raw pointer) cannot make it read out of
    bounds."""
    if not tix.is_cuda:
        raise ValueError(f"mb_sweep_thermo: tix is on {tix.device}; the CUDA kernel needs CUDA tensors (engine='torch' runs the plain version)")
    if tix.dtype != torch.int32:
        raise TypeError(f"mb_sweep_thermo: tix must be int32, got {tix.dtype}")
    if not tix.is_contiguous():
        raise ValueError("mb_sweep_thermo: tix must be contiguous")
    if tix.device != dev:
        raise ValueError(f"mb_sweep_thermo: tix is on {tix.device}, lnpi on {dev}")
    if tix.shape != mu.shape:
        raise ValueError(f"mb_sweep_thermo: tix must be [M] = {tuple(mu.shape)} like mu, got {tuple(tix.shape)}")
    seen = getattr(tix, "_mb_range", None)
    if seen is None or seen[0] != tix._version:
        lo, hi = (0, -1)
        if tix.numel():
            lo, hi = torch.stack(torch.aminmax(tix)).tolist()
            profiling.add("host_syncs")
        seen = tix._mb_range = (tix._version, lo, hi)
    if seen[1] < 0 or seen[2] >= A:
        raise ValueError(f"mb_sweep_thermo: tix spans [{seen[1]}, {seen[2]}], outside the {A} targets [0, {A})")


@profiling.spanned("fhmc.launch.k2")
def mb_sweep_thermo(
    lnpi, op, xrows, krows, volume, mu, a, tg, nspec: int, smooth: int, max_phases: int, order: int = 1,
    props: bool = True, first_order_mom: bool = False, collect=None, *, tix=None, _lanes=None, _xarea=None,
) -> dict:
    """Launch K2 for the M x A points (mu_m, target_t), b = m * A + t, or
    with ``tix`` for the M points (mu_b, target tix[b]).

    lnpi, op : f64[N]           composite surface and order parameter
    xrows    : f64[R, N]        mu-independent lnPI' rows (module docstring)
    krows    : f64[G, S+1, N]   key rows and their derivative rows, or None without props
    volume   : f64[]            box volume
    mu, a    : f64[M]           mu_1 per point and beta*(mu - mu0)
    tg       : f64[A, T]        per-target scalars
    tix      : i32[M] or None   each point's target (the paired mode)

    Returns the mu_sweep_thermo dict with a flat leading axis M*A (M with
    tix).  Runs on ``torch.cuda.current_stream()`` and synchronises only
    to read a new tix's range (see _check_tix; a point whose tix is out of
    range at launch comes back invalid).

    _lanes forces G, the lanes per point (tests and chip_smoke.py); by
    default ``lanes_per_point`` picks it, as for K1.  _xarea (True /
    False) forces x' formed once into the area or on every read (tests;
    the area only at G = 1); by default ``xarea_fits`` picks.  An area
    past what the card grants a block fails the launch, which raises.
    Either way the outputs are the same bits.
    """
    if _lanes is not None:
        check_lanes(_lanes)
    if _xarea not in (None, True, False):
        raise ValueError(f"mb_sweep_thermo: _xarea must be None, True or False, got {_xarea!r}")
    S = nspec
    tensors = {"lnpi": lnpi, "op": op, "xrows": xrows, "volume": volume, "mu": mu, "a": a, "tg": tg}
    if props:
        tensors["krows"] = krows
    for name, t in tensors.items():
        if t is None or not t.is_cuda:
            raise ValueError(f"mb_sweep_thermo: {name} is {'missing' if t is None else t.device}; the CUDA kernel needs CUDA tensors (engine='torch' runs the plain version)")
        if t.dtype != torch.float64:
            raise TypeError(f"mb_sweep_thermo: {name} must be float64, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"mb_sweep_thermo: {name} must be contiguous")
        if t.device != lnpi.device:
            raise ValueError(f"mb_sweep_thermo: {name} is on {t.device}, lnpi on {lnpi.device}")
    if S not in (1, 2):
        raise ValueError(f"mb_sweep_thermo: nspec must be 1 or 2, got {S}")
    if order not in (1, 2):
        raise ValueError(f"mb_sweep_thermo: the kernel implements orders 1-2, got {order}")
    N = lnpi.shape[0] if lnpi.dim() == 1 else -1
    if N < 1 or N >= 2**31 - 1 or op.shape != lnpi.shape or volume.numel() != 1:
        raise ValueError("mb_sweep_thermo: need lnpi, op [N] with 1 <= N < 2**31-1 and a scalar volume")
    if xrows.shape != (n_xrows(S, order), N):
        raise ValueError(f"mb_sweep_thermo: xrows must be [{n_xrows(S, order)}, {N}], got {tuple(xrows.shape)}")
    if props and krows.shape != (n_groups(S, order, first_order_mom), S + 1, N):
        raise ValueError(f"mb_sweep_thermo: krows must be [{n_groups(S, order, first_order_mom)}, {S + 1}, {N}], got {tuple(krows.shape)}")
    if mu.dim() != 1 or a.shape != mu.shape or tg.dim() != 2 or tg.shape[1] != n_xrows(S, order):
        raise ValueError(f"mb_sweep_thermo: need mu, a [M] and tg [A, {n_xrows(S, order)}]")
    cap = capacity(max_phases)
    if smooth < 1:
        raise ValueError("smooth must be >= 1 to find relative extrema (scipy argrelextrema rejects order 0 too)")
    if collect not in (None, "janus"):
        raise NotImplementedError(f"mb_sweep_thermo: the kernel implements collect None and 'janus', not {collect!r}")
    M, A = mu.shape[0], tg.shape[0]
    B, P, dev = (M * A if tix is None else M), max_phases, lnpi.device
    if B >= 2**31:
        raise ValueError(f"mb_sweep_thermo: {B} points exceed the kernel's int32 grid")
    if tix is not None:
        _check_tix(tix, mu, A, dev)

    index = dev.index if dev.index is not None else torch.cuda.current_device()
    G = lanes_per_point(N, B, sm_count(index), P) if _lanes is None else _lanes
    xarea = xarea_fits(G, cap, N) if _xarea is None else _xarea
    if xarea and G != 1:
        raise ValueError(f"mb_sweep_thermo: the x' area is the layout of one lane a point, not G={G}")
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
    rc = lib.mb_sweep_thermo_launch(
        index, torch.cuda.current_stream(dev).cuda_stream, G, cap, int(xarea),
        lnpi.data_ptr(), op.data_ptr(), xrows.data_ptr(), krows.data_ptr() if props else None,
        volume.data_ptr(), mu.data_ptr(), a.data_ptr(), tg.data_ptr(), None if tix is None else tix.data_ptr(),
        M, A, N, S, P, smooth, order, int(props), int(first_order_mom and order >= 2), int(collect == "janus"),
        ptr["fe"], ptr["left"], ptr["right"], ptr["mask"], ptr["n_phases"], ptr["valid"],
        *(ptr.get(k) for k in ("n_i", "x_i", "ntot", "u", "density")),
    )
    if rc != 0:
        raise RuntimeError(f"mb_sweep_thermo kernel launch failed: {lib.mb_sweep_thermo_error_string(rc).decode()} ({rc})")
    profiling.add("launches.k2")
    if xarea:
        profiling.add("launches.k2_xarea")
    return out


# ---------------------------------------------------------------------
# The row former: pipeline._mb_rows in one launch
# ---------------------------------------------------------------------
#
# csrc/mb_rows.cuh evaluates fixed formulas per bin; which moment rows they
# read is resolved here, once per (meta, order, props, first_order_mom),
# into its Table (the same fields, in the same order, flattened to ints).
# The kernel takes the table as a launch parameter, so no launch copies an
# index from pageable host memory.


class SgB(NamedTuple):
    """sgB(b) = DerivEngine.sg_dX_dB(b, 0): flat rows of mom [n_addr, N]."""

    zero: int  # no power of N or U: the row is 0
    b: int  # m(b)
    bu: int  # m(b + U)
    xni: tuple  # m(_xni(b, i)), i < nspec, padded to 2
    ke: int  # b's power of U where used_ke and it is > 0, else 0
    bd: int  # m(b - U) where ke


class SgM(NamedTuple):
    """sgM(b) = DerivEngine.sg_dX_dMU(0, b) (nspec 2)."""

    zero: int
    b: int  # m(b)
    xni: int  # m(_xni(b, 1))


class Slot(NamedTuple):
    """One address a of the key rows (N_i, then U) and what its rows read."""

    m: int  # m(a)
    a: SgB  # sgB(a)
    ma: SgM  # sgM(a)
    au: SgB  # sgB(a*U)
    an: tuple  # sgB(a*N_i), i < nspec, padded to 2
    ad: SgB  # sgB(a - U), the KE term of sgB2(a)
    pn: int  # m(N_1*a)
    pnb: SgB  # sgB(N_1*a)
    mn: SgM  # sgM(a*N_1)


class Table(NamedTuple):
    S: int
    order: int
    props: int
    khess: int  # the order-2 key rows are formed
    gate1: int  # max_order >= 2: the first-order key rows are not zero (_mb_rows' group gate)
    gate2: int  # max_order >= 3: nor the second-order ones
    key: tuple  # m(N_i), then m(U) at [nspec], padded to 3
    f11: tuple  # h11's fluctuation rows (nspec 2)
    slot: tuple  # one Slot a key address, padded to 3


_NO_SGB = SgB(0, 0, 0, (0, 0), 0, 0)
_NO_SGM = SgM(0, 0, 0)
_NO_SLOT = Slot(0, _NO_SGB, _NO_SGM, _NO_SGB, (_NO_SGB, _NO_SGB), _NO_SGB, 0, _NO_SGB, _NO_SGM)
_U = (0, 0, 0, 0, 1)


def _ints(v):
    if isinstance(v, tuple):  # NamedTuples too, in field order
        for x in v:
            yield from _ints(x)
    else:
        yield int(v)


TABLE_INTS = len(list(_ints(Table(0, 0, 0, 0, 0, 0, (0, 0, 0), (0, 0, 0), (_NO_SLOT,) * 3))))


@functools.lru_cache(maxsize=None)
def rows_table(meta, order: int, props: bool, first_order_mom: bool) -> Table:
    """The row former's table for these arguments.  It walks the moment
    addresses in the order pipeline._mb_rows reads them, through the same
    address rules (moments.mom_prod, derivs.xni_addr / check_order /
    zero_power), so it raises where _mb_rows raises, with its message."""
    S, mo = meta.nspec, meta.max_order
    if S not in (1, 2):
        raise ValueError(f"mb_rows: nspec must be 1 or 2, got {S}")
    if order not in (1, 2):
        raise ValueError(f"mb_rows: the row former implements orders 1-2, got {order}")
    dims = meta.mom_shape(0)[:5]

    def flat(a):
        for d, (v, n) in enumerate(zip(a, dims)):
            if not 0 <= v < n:
                raise IndexError(f"index {v} is out of bounds for dimension {d} with size {n}")
        i, j, k, m, p = a
        return (((i * meta.mo1 + j) * S + k) * meta.mo1 + m) * meta.mo1 + p

    def sgb(b):
        if zero_power(b):
            return SgB(1, 0, 0, (0, 0), 0, 0)
        check_order(b, mo)
        bu, mb = flat(b[:4] + (b[4] + 1,)), flat(b)
        xni = tuple(flat(xni_addr(b, i, mo)) for i in range(S))
        ke = b[4] if meta.used_ke and b[4] > 0 else 0
        return SgB(0, mb, bu, xni + (0,) * (2 - S), ke, flat(b[:4] + (b[4] - 1,)) if ke else 0)

    def sgm(b):
        if zero_power(b):
            return SgM(1, 0, 0)
        check_order(b, mo)
        return SgM(0, flat(b), flat(xni_addr(b, 1, mo)))

    def prod(x, y):
        return mom_prod(x, y, S, mo)

    N = [(s, 1, 0, 0, 0) for s in range(S)]
    addrs = N + [_U]
    key = [flat(a) for a in addrs]
    gate1, gate2 = int(2 <= mo), int(3 <= mo)
    khess = int(order >= 2 and not first_order_mom)
    f11 = (0, 0, 0)
    # xrows (at order 2 they read sgB(N_s), sgB(U))
    if order >= 2:
        for s in range(1, S):
            sgb(N[s])
        sgb(_U)
        if S == 2:
            f11 = tuple(flat(a) for a in ((1, 1, 1, 1, 0), (1, 1, 1, 0, 0), (1, 0, 1, 1, 0)))
    slots = [dict(m=key[k]) for k in range(S + 1)]
    if order >= 2 or (props and gate1):
        for k, a in enumerate(addrs):
            slots[k]["a"] = sgb(a)
    if props and gate1 and S == 2:
        for k, a in enumerate(addrs):
            slots[k]["ma"] = sgm(a)
    # the order-2 key rows; sgB and sgM of the key addresses themselves
    # were resolved above (gate2 implies gate1), so only the products can raise
    if props and khess and gate2:
        for k, a in enumerate(addrs):  # sg_d2X_dB2(a)
            slots[k]["au"] = sgb(prod(a, _U))
            slots[k]["an"] = tuple(sgb(prod(a, N[i])) for i in range(S)) + (_NO_SGB,) * (2 - S)
            if meta.used_ke and a[4] > 0:
                slots[k]["ad"] = sgb(a[:4] + (a[4] - 1,))
        if S == 2:
            for k, a in enumerate(addrs):  # the cross rows
                slots[k]["pn"] = flat(prod(N[1], a))
                slots[k]["pnb"] = sgb(prod(N[1], a))
            for k, a in enumerate(addrs):  # sg_d2X_dMU2(0, 0, a)
                slots[k]["mn"] = sgm(prod(a, N[1]))
    slot = tuple(_NO_SLOT._replace(**s) for s in slots) + (_NO_SLOT,) * (2 - S)
    return Table(S, order, int(props), khess, gate1, gate2, tuple(key) + (0,) * (2 - S), f11, slot)


@functools.lru_cache(maxsize=None)
def _table_array(meta, order: int, props: bool, first_order_mom: bool):
    ints = list(_ints(rows_table(meta, order, props, first_order_mom)))
    return (ctypes.c_int * len(ints))(*ints)


@profiling.spanned("fhmc.launch.mb_rows")
def mb_rows(h, meta, order: int, props: bool, first_order_mom: bool):
    """pipeline._mb_rows in one launch of the row former on the card:
    (xrows [R, N], krows [G, S+1, N] or None without props), equal to the
    plain version's bit for bit.  h is a one-state Hist (lnpi [N]) on a
    CUDA device; anything else raises before any launch, as do the
    max_order cases _mb_rows raises for.  Runs on
    ``torch.cuda.current_stream()``; does not synchronise."""
    table = _table_array(meta, order, props, first_order_mom)
    S, N, dev = meta.nspec, h.nbins, h.lnpi.device
    for name in ("lnpi", "mom", "op", "curr_mu", "curr_beta"):
        t = getattr(h, name)
        if not t.is_cuda:
            raise ValueError(f"mb_rows: {name} is on {t.device}; the CUDA kernel needs CUDA tensors (engine='torch' runs the plain version)")
        if t.dtype != torch.float64:
            raise TypeError(f"mb_rows: {name} must be float64, got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"mb_rows: {name} is on {t.device}, lnpi on {dev}")
    if h.lnpi.dim() != 1 or h.op.shape != (N,) or h.mom.shape != meta.mom_shape(N) or h.curr_mu.shape != (S,) or h.curr_beta.numel() != 1:
        raise ValueError(
            f"mb_rows: needs one state, lnpi and op [N], mom {meta.mom_shape('N')}, curr_mu [{S}] and a scalar curr_beta; "
            f"got lnpi {tuple(h.lnpi.shape)}, mom {tuple(h.mom.shape)}, curr_mu {tuple(h.curr_mu.shape)}"
        )
    mom, op, mu = h.mom.contiguous(), h.op.contiguous(), h.curr_mu.contiguous()
    f64 = dict(dtype=torch.float64, device=dev)
    xrows = torch.empty((n_xrows(S, order), N), **f64)
    krows = torch.empty((n_groups(S, order, first_order_mom), S + 1, N), **f64) if props else None
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    lib = _lib()
    rc = lib.mb_rows_launch(
        index, torch.cuda.current_stream(dev).cuda_stream, table, mom.data_ptr(), op.data_ptr(), h.curr_beta.data_ptr(), mu.data_ptr(),
        xrows.data_ptr(), None if krows is None else krows.data_ptr(), N,
    )
    if rc != 0:
        raise RuntimeError(f"mb_rows kernel launch failed: {lib.mb_sweep_thermo_error_string(rc).decode()} ({rc})")
    profiling.add("launches.mb_rows")
    return xrows, krows
