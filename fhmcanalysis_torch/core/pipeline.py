"""Batched pipelines over state-point grids.

One call sweeps a whole grid of mu_1 values, or of (mu_1, beta, dMu)
points: reweight, extrapolate, segment, integrate, where the reference
loops point by point (gc_binary.pyx:243-290, 406-410).  All outputs are
fixed-shape padded tensors + masks; failed state points surface as
valid=False rather than exceptions.
"""

from __future__ import annotations

import torch

from ..utils import profiling
from . import cuda_mb, cuda_sweep, launch
from .derivs import DerivEngine
from .segment import COLLECT_TRANSFORMS, key_rows, thermo_core, thermo_core_props, thermo_key_core
from .state import Hist, HistMeta

__all__ = ["mu_sweep_thermo", "mu_sweep_body", "mu_beta_sweep_thermo", "mu_beta_sweep_body", "most_stable_phase"]

# Points per plain-version chunk, as a budget of B*P*N elements (the plain
# version keeps several [B, P, N]-sized f64 and bool tensors live).
# Measured on one H100 80GB at the n573 / n31 sweep cells: 2**28 peaks at
# 4.9 / 5.7 GiB and runs 7% / 5% faster than 2**26; 2**29 gains 2% more
# for twice the memory, 2**24 is 1.4-1.6x slower (PERF.md).
_PLAIN_CHUNK_ELEMS = 2**28


def _reweight_coeff(h: Hist, mu: torch.Tensor) -> torch.Tensor:
    """a = (mu - mu0) * beta per point, associated as the JAX package's
    pipeline._point_thermo does; the kernel and the plain version both
    form x = lnpi + a * op from this same tensor."""
    return (mu - h.curr_mu[0]) * h.curr_beta


def _sweep_out(pt, pp) -> dict:
    """The sweep's output dict from the tail's (pt, pp): the segmentation
    fields, then with props (pp not None) the phase properties."""
    out = {"fe": pt.fe, "mask": pt.mask, "left": pt.left, "right": pt.right, "n_phases": pt.n_phases, "valid": pt.valid}
    if pp is not None:
        out.update(pp)
    return out


def _chunked(fn, n: int, per: int) -> dict:
    """fn(sl) over consecutive slices sl of at most `per` of n points (one
    slice where n <= per), the sweep dicts concatenated along the points."""
    if n <= per:
        return fn(slice(0, n))
    outs = [fn(slice(i, i + per)) for i in range(0, n, per)]
    return {k: torch.cat([o[k] for o in outs]) for k in outs[0]}


def _point_thermo(h: Hist, meta: HistMeta, mu: torch.Tensor, props: bool, collect=None) -> dict:
    """Fused reweight+thermo for a [B] batch of mu_1 values (plain version).

    lnPI is never normalized: fe and the per-phase averages are invariant
    under lnpi -> lnpi + c, so segmentation runs on the raw reweighted
    surface and integration uses per-phase max-shifted weights.
    """
    x = h.lnpi + _reweight_coeff(h, mu)[:, None] * h.op
    if props:
        return _sweep_out(*thermo_core_props(x, h.mom, meta, h.volume, collect=collect))
    return _sweep_out(thermo_core(x, h.mom, meta, props=False, collect=collect), None)


def mu_sweep_body(h: Hist, meta: HistMeta, mu_grid, props: bool = True, collect=None) -> dict:
    """The plain PyTorch sweep on any device, chunked over points so the
    [B, P, N] intermediates fit in memory."""
    mu = torch.as_tensor(mu_grid, dtype=torch.float64, device=h.device)
    per = max(1, _PLAIN_CHUNK_ELEMS // (meta.max_phases * h.nbins))
    return _chunked(lambda sl: _point_thermo(h, meta, mu[sl], props, collect), mu.shape[0], per)


def _on_kernel(engine: str, device: torch.device, collect=None, lanes=None) -> bool:
    """The route of an entry point: True for the kernels (engine "cuda",
    or "auto" on a CUDA device), False for the plain version ("torch", or
    "auto" elsewhere).  Raises for an engine, a collect or a forced
    layout (lanes) the package does not have."""
    if engine not in ("auto", "torch", "cuda"):
        raise ValueError(f"engine must be 'auto', 'torch' or 'cuda', got {engine!r}")
    if collect is not None and collect not in COLLECT_TRANSFORMS:
        raise KeyError(collect)
    if lanes is not None:
        launch.check_lanes(lanes)
    return engine == "cuda" or (engine == "auto" and device.type == "cuda")


@profiling.spanned("fhmc.entry.mu_sweep")
def mu_sweep_thermo(h: Hist, meta: HistMeta, mu_grid, props: bool = True, collect=None, engine: str = "auto", *, _lanes=None) -> dict:
    """Reweight + thermo over a 1-D grid of mu_1 values.

    Returns a dict of tensors with leading axis len(mu_grid): per-phase
    padded free energies, bounds, masks and (with props) phase properties
    n_i, x_i [B,P,S] and ntot, u, density [B,P].

    collect: optional segment.COLLECT_TRANSFORMS key ("janus") — the
    batched analog of thermo(collect=...) (gc_hist.pyx:484-486).
    engine: "auto" follows the tensors' device: CUDA launches the fused
    kernel (cuda_sweep), CPU runs the plain version.  "torch" forces the
    plain version on either device; "cuda" forces the kernel and raises
    for CPU tensors.  A kernel failure raises; nothing falls back.
    _lanes forces the kernel's lanes per point (launch.lanes_per_point
    picks it otherwise); tests and chip_smoke.py use it.
    """
    if not _on_kernel(engine, h.device, collect, _lanes):
        return mu_sweep_body(h, meta, mu_grid, props, collect)
    with profiling.span("fhmc.prologue.reweight"):
        mu = torch.as_tensor(mu_grid, dtype=torch.float64, device=h.device)
        keys = key_rows(h.mom, meta).contiguous()
        a = _reweight_coeff(h, mu).contiguous()
        lnpi, op = h.lnpi.contiguous(), h.op.contiguous()
    return cuda_sweep.sweep_thermo(lnpi, op, keys, h.volume, a, meta.smooth, meta.max_phases, props, collect, _lanes=_lanes)


# ---------------------------------------------------------------------
# (mu_1, beta, dMu) extrapolating sweep
# ---------------------------------------------------------------------
#
# Per point (mu_m, beta_t, dMu_t) the JAX package reweights to mu_m, takes
# the joint Taylor step in (dB, dDmu) = (beta_t - beta, dMu_t - dMu_ref)
# (extrap.temp_dmu_extrap_key) and runs the thermo tail.  Every
# grand-canonical average in that step (<N_i>, <U>, and at order 2 the
# gc_dX_dB fluctuations) enters lnPI' as a constant that is the same in
# every bin, and no key-row derivative holds one.  The tail cancels any
# constant (fe = x'[0] - m_p - log sum exp(x' - m_p); the properties are
# ratios), so here lnPI' is built without them:
#
#   x'  = lnpi + a_m op + dB (r1 + mu_m op) + sum_q dd_q mq
#         + [order 2] 1/2 (dB^2 h00 + 2 dB dd h01 + dd^2 h11)
#   key'_k = key_k + dB sgB_k + sum_q dd_q sgM_qk
#         + [order 2, not first_order_mom] 1/2 (dB^2 sgB2_k + 2 dB dd sgX_k + dd^2 sgM2_k)
#
# from mu-independent semigrand rows computed once per call: on the kernel
# route by one launch of the row former (cuda_mb.mb_rows), elsewhere by
# its plain version _mb_rows, bit for bit the same rows.
# The plain version below and kernel K2 (cuda_mb) form x' in the same
# association with elementwise products and sums only, so segmentation
# agrees bit for bit.  tests/test_torch_mb.py holds the result against the
# JAX package and against the port's own literal reweight -> extrap ->
# thermo composition.


def _mb_rows(h: Hist, meta: HistMeta, order: int, props: bool, first_order_mom: bool):
    """The mu-independent rows of the extrapolating sweep, in the layout
    of cuda_mb: xrows [R, N] (r1, mq..., then at order 2 h00, h01, h11) and
    krows [G, S+1, N] (key, sgB, sgM..., then at order 2 unless
    first_order_mom sgB2, sgX, sgM2), or None without props.  The moment
    gate of the JAX engine's _mom_loop (j+m+p+order <= max_order) zeroes a
    key-row derivative the moments are too short for.  The plain version
    of the row former, cuda_mb.mb_rows (see _rows)."""
    S = meta.nspec
    eng = DerivEngine(h, meta)
    beta = h.curr_beta
    dmuref = h.curr_mu[1:] - h.curr_mu[0]
    n = [eng.m((s, 1, 0, 0, 0)) for s in range(S)]
    U = (0, 0, 0, 0, 1)
    acc = torch.zeros_like(h.lnpi)
    for s in range(1, S):
        acc = acc + dmuref[s - 1] * n[s]
    xrows = [acc - eng.m(U)] + [beta * n[q + 1] for q in range(S - 1)]
    if order >= 2:
        acc = torch.zeros_like(h.lnpi)
        for s in range(1, S):
            acc = acc + dmuref[s - 1] * eng.sg_dX_dB((s, 1, 0, 0, 0), 0)
        xrows.append(acc - eng.sg_dX_dB(U, 0))
        if S == 2:
            f11 = eng.m((1, 1, 1, 1, 0)) - eng.m((1, 1, 1, 0, 0)) * eng.m((1, 0, 1, 1, 0))
            xrows += [n[1] + beta * eng.sg_dX_dB((1, 1, 0, 0, 0), 0), beta**2 * f11]
    if not props:
        return torch.stack(xrows).contiguous(), None

    addrs = [(s, 1, 0, 0, 0) for s in range(S)] + [U]

    def group(o, fn):
        return torch.stack([fn(a) if 1 + o <= meta.max_order else torch.zeros_like(h.lnpi) for a in addrs])

    def cross(a):
        nq = (1, 1, 0, 0, 0)
        f = eng.m(eng._prod(nq, a)) - eng.m(nq) * eng.m(a)
        return beta * eng.sg_df_dB((nq, 0), (a, 0)) + f

    groups = [key_rows(h.mom, meta), group(1, lambda a: eng.sg_dX_dB(a, 0))]
    groups += [group(1, lambda a, q=q: eng.sg_dX_dMU(q, a)) for q in range(S - 1)]
    if order >= 2 and not first_order_mom:
        groups.append(group(2, lambda a: eng.sg_d2X_dB2(a, 0)))
        if S == 2:
            groups += [group(2, cross), group(2, lambda a: eng.sg_d2X_dMU2(0, 0, a))]
    return torch.stack(xrows).contiguous(), torch.stack(groups).contiguous()


def _rows(h: Hist, meta: HistMeta, order: int, props: bool, first_order_mom: bool, kernel: bool):
    """_mb_rows' rows: one launch of the row former on the kernel route,
    which raises for CPU tensors; else the plain _mb_rows."""
    return (cuda_mb.mb_rows if kernel else _mb_rows)(h, meta, order, props, first_order_mom)


def _mb_targets(h: Hist, meta: HistMeta, beta_grid, dmu_grid, order: int) -> torch.Tensor:
    """Per-target scalars [A, T] in cuda_mb's layout: dB, dd (nspec 2),
    then at order 2 dB^2, 2 dB dd, dd^2 -- formed once here so the kernel
    and the plain version multiply by the same values."""
    f64 = dict(dtype=torch.float64, device=h.device)
    betas = torch.atleast_1d(torch.as_tensor(beta_grid, **f64))
    dmus = torch.atleast_2d(torch.as_tensor(dmu_grid, **f64))
    A, S = betas.shape[0], meta.nspec
    if dmus.shape[1] != S - 1 or dmus.shape[0] not in (1, A):
        raise ValueError(f"dmu_grid must be [A or 1, nspec-1] = [{A} or 1, {S - 1}], got {tuple(dmus.shape)}")
    dB = betas - h.curr_beta
    cols = [dB] + [dmus[:, q].expand(A) - (h.curr_mu[q + 1] - h.curr_mu[0]) for q in range(S - 1)]
    if order >= 2:
        cols.append(dB * dB)
        if S == 2:
            dd = cols[1]
            cols += [2.0 * dB * dd, dd * dd]
    return torch.stack(cols, dim=1).contiguous()


def _mb_chunk(h: Hist, meta: HistMeta, mu, a, xrows, krows, tg, order: int, props: bool, collect, tix=None) -> dict:
    """The plain extrapolating sweep over mu [m] x the A targets of tg, or
    with tix [m] over the m points (mu_b, target tix[b]): x' and key' in
    cuda_mb's association, then the thermo tail.  Both modes form each
    point's x' from the same scalars with the same operations, so a paired
    point equals the product's (m, tix[m]) bit for bit."""
    S, N = meta.nspec, h.nbins
    if tix is None:  # a target scalar against [m, A, N]
        col = lambda j: tg[:, j][None, :, None]  # noqa: E731
        x = (h.lnpi + a[:, None] * h.op)[:, None, :]
        t = (xrows[0] + mu[:, None] * h.op)[:, None, :]
        B = mu.shape[0] * tg.shape[0]
    else:  # a point's target scalar against [m, N]
        col = lambda j: tg[tix, j][:, None]  # noqa: E731
        x = h.lnpi + a[:, None] * h.op
        t = xrows[0] + mu[:, None] * h.op
        B = mu.shape[0]
    xp = x + col(0) * t
    if S == 2:
        xp = xp + col(1) * xrows[1]
    if order >= 2:
        q = col(S) * xrows[S]
        if S == 2:
            q = q + col(3) * xrows[3]
            q = q + col(4) * xrows[4]
        xp = xp + 0.5 * q
    xp = xp.reshape(B, N)
    if not props:
        return _sweep_out(thermo_core(xp, h.mom, meta, props=False, collect=collect), None)
    kc = lambda j: tg[:, j][:, None, None]  # noqa: E731  a target scalar against [A, S+1, N]
    kp = krows[0] + kc(0) * krows[1]
    if S == 2:
        kp = kp + kc(1) * krows[2]
    if krows.shape[0] > 1 + S:
        q = kc(S) * krows[1 + S]
        if S == 2:
            q = q + kc(3) * krows[4]
            q = q + kc(4) * krows[5]
        kp = kp + 0.5 * q
    kp = kp[None].expand((mu.shape[0],) + kp.shape).reshape(B, S + 1, N) if tix is None else kp[tix]
    return _sweep_out(*thermo_key_core(xp, kp, meta, h.volume, collect=collect))


def _mb_paired_body(h: Hist, meta: HistMeta, mu, a, xrows, krows, tg, tix, order: int, props: bool, collect=None) -> dict:
    """The plain paired extrapolating sweep (K2's paired mode) over the
    points (mu_b, target tix[b]) on any device, chunked over points so the
    [B, P, N] intermediates fit in memory; rows and targets as
    _mb_rows / _mb_targets build them."""
    per = max(1, _PLAIN_CHUNK_ELEMS // (meta.max_phases * h.nbins))
    return _chunked(lambda sl: _mb_chunk(h, meta, mu[sl], a[sl], xrows, krows, tg, order, props, collect, tix[sl]), mu.shape[0], per)


def _check_mb(meta: HistMeta, order: int) -> None:
    if order not in (1, 2):
        raise ValueError(f"the extrapolating sweep implements orders 1-2, got {order}")
    if meta.nspec not in (1, 2):
        raise ValueError(f"the extrapolating sweep implements nspec 1-2 (the moment algebra's limit), got {meta.nspec}")


def _mb_inputs(h: Hist, meta: HistMeta, mu_grid, beta_grid, dmu_grid, order: int, props: bool, first_order_mom: bool, kernel: bool = False):
    """mu, a, xrows, krows, tg of the extrapolating sweep; kernel: the rows
    from the row former (see _rows)."""
    _check_mb(meta, order)
    mu = torch.atleast_1d(torch.as_tensor(mu_grid, dtype=torch.float64, device=h.device)).contiguous()
    with profiling.span("fhmc.prologue.mb_targets"):
        tg = _mb_targets(h, meta, beta_grid, dmu_grid, order)
    with profiling.span("fhmc.prologue.mb_rows"):
        xrows, krows = _rows(h, meta, order, props, first_order_mom, kernel)
    return mu, _reweight_coeff(h, mu).contiguous(), xrows, krows, tg


def _mb_shape(flat: dict, M: int, A: int) -> dict:
    return {k: v.reshape((M, A) + v.shape[1:]) for k, v in flat.items()}


def mu_beta_sweep_body(
    h: Hist, meta: HistMeta, mu_grid, beta_grid, dmu_grid, order: int = 1, props: bool = True, first_order_mom: bool = False, collect=None
) -> dict:
    """The plain PyTorch (mu_1, beta, dMu) sweep on any device, chunked
    over mu so the [B, P, N] intermediates fit in memory; see
    mu_beta_sweep_thermo."""
    mu, a, xrows, krows, tg = _mb_inputs(h, meta, mu_grid, beta_grid, dmu_grid, order, props, first_order_mom)
    M, A = mu.shape[0], tg.shape[0]
    per = max(1, _PLAIN_CHUNK_ELEMS // (meta.max_phases * h.nbins * A))
    return _mb_shape(_chunked(lambda sl: _mb_chunk(h, meta, mu[sl], a[sl], xrows, krows, tg, order, props, collect), M, per), M, A)


@profiling.spanned("fhmc.entry.mb_sweep")
def mu_beta_sweep_thermo(
    h: Hist,
    meta: HistMeta,
    mu_grid,
    beta_grid,
    dmu_grid,
    order: int = 1,
    props: bool = True,
    first_order_mom: bool = False,
    collect=None,
    engine: str = "auto",
    *,
    _lanes=None,
) -> dict:
    """Full (mu_1, beta, dMu) product sweep: reweight -> joint Taylor
    extrapolation -> thermo.

    mu_grid: [M], beta_grid: [A], dmu_grid: [A or 1, S-1] paired with beta
    row by row: every (mu, (beta, dmu)) pair is evaluated; returns the
    mu_sweep_thermo dict with leading axes [M, A].  order 1 or 2;
    first_order_mom keeps the moment rows at first order.

    engine: "auto" follows the tensors' device: CUDA launches the row
    former and kernel K2 (cuda_mb) and raises for what they do not cover,
    CPU runs the plain version.  "torch" forces the plain version on either device; "cuda"
    forces the kernel and raises for CPU tensors.  Nothing falls back.
    _lanes forces K2's lanes per point, as for mu_sweep_thermo.
    """
    if not _on_kernel(engine, h.device, collect, _lanes):
        return mu_beta_sweep_body(h, meta, mu_grid, beta_grid, dmu_grid, order, props, first_order_mom, collect)
    mu, a, xrows, krows, tg = _mb_inputs(h, meta, mu_grid, beta_grid, dmu_grid, order, props, first_order_mom, kernel=True)
    flat = cuda_mb.mb_sweep_thermo(
        h.lnpi.contiguous(), h.op.contiguous(), xrows, krows, h.volume, mu, a, tg,
        meta.nspec, meta.smooth, meta.max_phases, order, props, first_order_mom, collect, _lanes=_lanes,
    )
    return _mb_shape(flat, mu.shape[0], tg.shape[0])


def most_stable_phase(fe, mask):
    """Index of the minimum-free-energy phase among valid slots.

    Parity: _get_most_stable_phase (gc_binary.pyx:83-107).
    """
    return torch.argmin(torch.where(mask, fe, torch.inf), dim=-1)
