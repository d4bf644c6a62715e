"""Taylor extrapolation of lnPI and the moments tensor in (beta, dMu).

Single-target drivers mirror the reference's _temp_extrap_{1,2,3},
_dmu_extrap_{1,2} and _temp_dmu_extrap_{1,2} (ntot/gc_hist.pyx:1995-2340,
1045-1239); the grid drivers replace the clone-per-target loops of
temp_dmu_extrap_multi (gc_hist.pyx:813-887) by computing the derivatives
once and applying them to every target by broadcasting.  Function for
function the JAX package's ``core/extrap.py``; its contractions over the
S <= 2 (beta, dMu) axis are written out as sums here.
"""

from __future__ import annotations

import torch

from .derivs import DerivEngine, DerivEngineN1
from .numerics import normalize_lnpi
from .segment import key_row_addresses
from .state import Hist, HistMeta

__all__ = [
    "temp_extrap",
    "dmu_extrap",
    "temp_dmu_extrap",
    "temp_dmu_extrap_key",
    "temp_dmu_extrap_grid",
    "temp_mu_extrap",
    "temp_mu_extrap_grid",
]


def _f64(h: Hist, v):
    return torch.as_tensor(v, dtype=h.lnpi.dtype, device=h.device)


def _dmu_of(h: Hist):
    return h.curr_mu[1:] - h.curr_mu[0]


def _lin(xi, d):
    """sum_s xi[..., s] * d[s] over the leading axis of d (tensordot)."""
    tail = (1,) * (d.dim() - 1)
    acc = xi[..., 0].reshape(xi.shape[:-1] + tail) * d[0]
    for s in range(1, d.shape[0]):
        acc = acc + xi[..., s].reshape(xi.shape[:-1] + tail) * d[s]
    return acc


def _quad(xi, H):
    """sum_{r,q} xi[..., r] H[r, q] xi[..., q] (the einsum "r,rq...,q")."""
    tail = (1,) * (H.dim() - 2)
    S = H.shape[0]
    acc = None
    for r in range(S):
        for q in range(S):
            c = (xi[..., r] * xi[..., q]).reshape(xi.shape[:-1] + tail)
            acc = c * H[r, q] if acc is None else acc + c * H[r, q]
    return acc


def _check(order: int, lo: int, hi: int, what: str):
    if order > hi or order < lo:
        raise ValueError("No implementation for %s extrapolation of order %d" % (what, order))


def temp_extrap(h: Hist, meta: HistMeta, target_beta, order: int = 1, skip_mom: bool = False, engine_cls=DerivEngine) -> Hist:
    """Extrapolate in temperature only (orders 1-3).

    Parity: histogram.temp_extrap driver sequence (gc_hist.pyx:670-740):
    normalize, accumulate Taylor series, set curr_beta, renormalize.
    """
    h = h.replace(lnpi=normalize_lnpi(h.lnpi))
    eng = engine_cls(h, meta)
    target_beta = _f64(h, target_beta)
    dB = target_beta - h.curr_beta

    d1, m1 = eng.dB(skip_mom)
    lnpi = h.lnpi + dB * d1
    mom = h.mom + dB * m1
    if order >= 2:
        d2, m2 = eng.dB2(skip_mom)
        lnpi = lnpi + 0.5 * dB * dB * d2
        mom = mom + 0.5 * dB * dB * m2
    if order >= 3:
        d3, m3 = eng.dB3(skip_mom)
        lnpi = lnpi + (1.0 / 6.0) * dB * dB * dB * d3
        mom = mom + (1.0 / 6.0) * dB * dB * dB * m3
    _check(order, 1, 3, "temperature")
    return h.replace(lnpi=normalize_lnpi(lnpi), mom=mom, curr_beta=target_beta)


def dmu_extrap(h: Hist, meta: HistMeta, target_dmu, order: int = 1, skip_mom: bool = False) -> Hist:
    """Extrapolate in dMu = mu_{2..S} - mu_1 (orders 1-2).

    Parity: histogram.dmu_extrap (gc_hist.pyx:742-811, 2254-2340).
    """
    h = h.replace(lnpi=normalize_lnpi(h.lnpi))
    eng = DerivEngine(h, meta)
    target_dmu = _f64(h, target_dmu)
    dDmu = target_dmu - _dmu_of(h)  # [S-1]

    d1, m1 = eng.dMU(skip_mom)
    lnpi = h.lnpi + _lin(dDmu, d1)
    mom = h.mom + _lin(dDmu, m1)
    if order >= 2:
        H, Hm = eng.dMU2(skip_mom)
        lnpi = lnpi + 0.5 * _quad(dDmu, H)
        mom = mom + 0.5 * _quad(dDmu, Hm)
    _check(order, 1, 2, "dMu")
    return h.replace(lnpi=normalize_lnpi(lnpi), mom=mom, curr_mu=torch.cat([h.curr_mu[:1], h.curr_mu[0] + target_dmu]))


def _xi(h: Hist, target_beta, target_dmu):
    """[dB, dDmu_2..S] of one target, and the two targets as tensors."""
    target_beta = _f64(h, target_beta)
    target_dmu = _f64(h, target_dmu)
    xi = torch.cat([(target_beta - h.curr_beta)[None], target_dmu - _dmu_of(h)])  # [S]
    return xi, target_beta, target_dmu


def temp_dmu_extrap(
    h: Hist,
    meta: HistMeta,
    target_beta,
    target_dmu,
    order: int = 1,
    skip_mom: bool = False,
    first_order_mom: bool = False,
    sg_memo: dict | None = None,
) -> Hist:
    """Joint (beta, dMu) extrapolation (orders 1-2).

    Parity: histogram.temp_dmu_extrap (gc_hist.pyx:889-966, 1045-1092,
    1182-1239).  xi = [dB, dDmu_2, ..., dDmu_S].

    sg_memo: optional derivs.warm_sg_memo(...) dict: the mu-independent
    semigrand rows, shared instead of recomputed.
    """
    h = h.replace(lnpi=normalize_lnpi(h.lnpi))
    eng = DerivEngine(h, meta)
    if sg_memo:
        eng._memo.update(sg_memo)
    xi, target_beta, target_dmu = _xi(h, target_beta, target_dmu)

    d1, m1 = eng.dBMU(skip_mom)
    lnpi = h.lnpi + _lin(xi, d1)
    mom = h.mom + _lin(xi, m1)
    if order >= 2:
        H, Hm = eng.dBMU2(skip_mom)
        lnpi = lnpi + 0.5 * _quad(xi, H)
        if not first_order_mom:
            mom = mom + 0.5 * _quad(xi, Hm)
    _check(order, 1, 2, "temperature + dMu")
    new_mu = torch.cat([h.curr_mu[:1], h.curr_mu[0] + target_dmu])
    return h.replace(lnpi=normalize_lnpi(lnpi), mom=mom, curr_beta=target_beta, curr_mu=new_mu)


def temp_dmu_extrap_key(
    h: Hist,
    meta: HistMeta,
    target_beta,
    target_dmu,
    order: int = 1,
    first_order_mom: bool = False,
    sg_memo: dict | None = None,
):
    """Joint (beta, dMu) extrapolation of lnPI plus ONLY the key moment
    rows (<N_i>, <U>: segment.key_row_addresses).

    Same Taylor series as temp_dmu_extrap; the moment apply touches the
    nspec+1 rows the phase properties read.  Returns (lnpi, key_rows)
    with lnpi UNNORMALIZED: consumers integrate with per-phase shifts
    (segment.thermo_key_core).
    """
    h = h.replace(lnpi=normalize_lnpi(h.lnpi))
    eng = DerivEngine(h, meta)
    if sg_memo:
        eng._memo.update(sg_memo)
    xi, _, _ = _xi(h, target_beta, target_dmu)
    N = h.nbins
    kra = key_row_addresses(meta)
    S = xi.shape[0]

    d1, m1 = eng.dBMU(False)
    m1k = m1.reshape(S, meta.n_addr, N)[:, kra, :]  # [S, K, N]
    lnpi = h.lnpi + _lin(xi, d1)
    key = h.mom.reshape(meta.n_addr, N)[kra, :] + _lin(xi, m1k)
    if order >= 2:
        H, Hm = eng.dBMU2(False)
        lnpi = lnpi + 0.5 * _quad(xi, H)
        if not first_order_mom:
            key = key + 0.5 * _quad(xi, Hm.reshape(S, S, meta.n_addr, N)[:, :, kra, :])
    _check(order, 1, 2, "temperature + dMu")
    return lnpi, key


def _grid_xi(h: Hist, target_betas, dx):
    """xi[a, b, s] over a (beta, dMu or mu) target grid: s=0 is beta."""
    target_betas = torch.atleast_1d(_f64(h, target_betas))  # [A]
    A, B = target_betas.shape[0], dx.shape[0]
    dB = (target_betas - h.curr_beta)[:, None, None].expand(A, B, 1)
    return torch.cat([dB, dx[None].expand(A, B, dx.shape[1])], dim=-1), target_betas


def _grid_hist(h: Hist, lnpi, mom, target_betas, mu_rest):
    """A Hist with leading axes [A, B] from grid-applied lnpi and moments;
    mu_rest[b] are mu_2..S of the targets."""
    A, B = lnpi.shape[:2]
    curr_mu = torch.cat([h.curr_mu[0].expand(A, B, 1), mu_rest[None].expand(A, B, mu_rest.shape[1])], dim=-1)
    return Hist(
        lnpi=normalize_lnpi(lnpi),
        mom=mom,
        op=h.op.expand((A, B) + h.op.shape),
        curr_mu=curr_mu,
        curr_beta=target_betas[:, None].expand(A, B),
        volume=h.volume.expand(A, B),
    )


def temp_dmu_extrap_grid(
    h: Hist,
    meta: HistMeta,
    target_betas,
    target_dmus,
    order: int = 1,
    skip_mom: bool = False,
    first_order_mom: bool = False,
) -> Hist:
    """Batched joint extrapolation over the full (beta, dMu) target grid.

    Replaces temp_dmu_extrap_multi (gc_hist.pyx:813-887): derivatives are
    computed once and applied to every target by broadcasting.  Returns a
    Hist whose tensors carry leading axes [n_beta, n_dmu].
    """
    h = h.replace(lnpi=normalize_lnpi(h.lnpi))
    eng = DerivEngine(h, meta)
    target_dmus = torch.atleast_2d(_f64(h, target_dmus))  # [B, S-1]
    xi, target_betas = _grid_xi(h, target_betas, target_dmus - _dmu_of(h))

    d1, m1 = eng.dBMU(skip_mom)
    lnpi = h.lnpi + _lin(xi, d1)
    mom = h.mom + _lin(xi, m1)
    if order >= 2:
        H, Hm = eng.dBMU2(skip_mom)
        lnpi = lnpi + 0.5 * _quad(xi, H)
        if not first_order_mom:
            mom = mom + 0.5 * _quad(xi, Hm)
    _check(order, 1, 2, "temperature + dMu")
    return _grid_hist(h, lnpi, mom, target_betas, h.curr_mu[0] + target_dmus)


def temp_mu_extrap(h: Hist, meta: HistMeta, target_beta, target_mus, order: int = 1, skip_mom: bool = False) -> Hist:
    """Joint (beta, absolute mu_2..mu_S) extrapolation for the N_1 engine.

    Parity: n1 histogram.temp_mu_extrap (n1/gc_hist.pyx:566-1043).
    xi = [dB, mu' - mu_curr] with absolute chemical potentials; the n1
    second-order moment apply has no first_order_mom switch.
    """
    h = h.replace(lnpi=normalize_lnpi(h.lnpi))
    eng = DerivEngineN1(h, meta)
    target_beta = _f64(h, target_beta)
    target_mus = _f64(h, target_mus)
    xi = torch.cat([(target_beta - h.curr_beta)[None], target_mus - h.curr_mu[1:]])  # [S]

    d1, m1 = eng.dBMU(skip_mom)
    lnpi = h.lnpi + _lin(xi, d1)
    mom = h.mom + _lin(xi, m1)
    if order >= 2:
        H, Hm = eng.dBMU2(skip_mom)
        lnpi = lnpi + 0.5 * _quad(xi, H)
        mom = mom + 0.5 * _quad(xi, Hm)
    _check(order, 1, 2, "temperature + mu")
    new_mu = torch.cat([h.curr_mu[:1], target_mus])
    return h.replace(lnpi=normalize_lnpi(lnpi), mom=mom, curr_beta=target_beta, curr_mu=new_mu)


def temp_mu_extrap_grid(h: Hist, meta: HistMeta, target_betas, target_mus, order: int = 1, skip_mom: bool = False) -> Hist:
    """Batched (beta, absolute mu) grid extrapolation for the N_1 engine.

    Replaces temp_mu_extrap_multi (n1/gc_hist.pyx:1497-1733); returns a
    Hist with leading axes [n_beta, n_mu].
    """
    h = h.replace(lnpi=normalize_lnpi(h.lnpi))
    eng = DerivEngineN1(h, meta)
    target_mus = torch.atleast_2d(_f64(h, target_mus))  # [B, S-1]
    xi, target_betas = _grid_xi(h, target_betas, target_mus - h.curr_mu[1:])

    d1, m1 = eng.dBMU(skip_mom)
    lnpi = h.lnpi + _lin(xi, d1)
    mom = h.mom + _lin(xi, m1)
    if order >= 2:
        H, Hm = eng.dBMU2(skip_mom)
        lnpi = lnpi + 0.5 * _quad(xi, H)
        mom = mom + 0.5 * _quad(xi, Hm)
    _check(order, 1, 2, "temperature + mu")
    return _grid_hist(h, lnpi, mom, target_betas, target_mus)
