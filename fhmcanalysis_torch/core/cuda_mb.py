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

The plain version of this kernel is ``pipeline.mu_beta_sweep_body``;
nothing on the CUDA path calls it.  ``pipeline.mu_beta_sweep_thermo``
picks between the two by the tensors' device.

Row layouts (built by ``pipeline._mb_rows`` / ``_mb_targets``):
  xrows [R, N]     r1, mq (nspec 2), then at order 2: h00, h01, h11 (nspec 2)
  krows [G, S+1, N] key, sgB, sgM (nspec 2), then at order 2 unless
                    first_order_mom: sgB2, sgX, sgM2 (nspec 2)
  tg    [A, T]     dB, dd (nspec 2), then at order 2: dB^2, 2 dB dd, dd^2

Two modes: the product of the M mu values and the A targets, and with
``tix`` the paired mode, one target per mu (the coexistence solver's,
``core/solve.py``).
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..utils import profiling
from .cuda_sweep import MAX_PHASES, capacity, check_capacities, check_lanes, lanes_per_point, sm_count  # noqa: F401  (MAX_PHASES: the kernel's, as cuda_sweep's)

NAME = "mb_sweep_thermo"


def n_xrows(S: int, order: int) -> int:
    """Rows of xrows, and columns of tg: each x' row has its target scalar."""
    return S + (0 if order < 2 else (1 if S == 1 else 3))


def n_groups(S: int, order: int, first_order_mom: bool) -> int:
    return 1 + S + (0 if order < 2 or first_order_mom else (1 if S == 1 else 3))


def _declare(lib: ctypes.CDLL) -> None:
    """Declare the library's C signatures and check its builds against this module."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.mb_sweep_thermo_launch.argtypes = [i, p, i, i] + [p] * 9 + [i] * 10 + [p] * 11
    lib.mb_sweep_thermo_launch.restype = i
    lib.mb_sweep_thermo_error_string.argtypes = [i]
    lib.mb_sweep_thermo_error_string.restype = ctypes.c_char_p
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
    props: bool = True, first_order_mom: bool = False, collect=None, *, tix=None, _lanes=None,
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
    default ``lanes_per_point`` picks it, as for K1.
    """
    if _lanes is not None:
        check_lanes(_lanes)
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
        index, torch.cuda.current_stream(dev).cuda_stream, G, cap,
        lnpi.data_ptr(), op.data_ptr(), xrows.data_ptr(), krows.data_ptr() if props else None,
        volume.data_ptr(), mu.data_ptr(), a.data_ptr(), tg.data_ptr(), None if tix is None else tix.data_ptr(),
        M, A, N, S, P, smooth, order, int(props), int(first_order_mom and order >= 2), int(collect == "janus"),
        ptr["fe"], ptr["left"], ptr["right"], ptr["mask"], ptr["n_phases"], ptr["valid"],
        *(ptr.get(k) for k in ("n_i", "x_i", "ntot", "u", "density")),
    )
    if rc != 0:
        raise RuntimeError(f"mb_sweep_thermo kernel launch failed: {lib.mb_sweep_thermo_error_string(rc).decode()} ({rc})")
    profiling.add("launches.k2")
    return out
