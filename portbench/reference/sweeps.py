"""The mu sweep and the (mu_1, beta, dMu) extrapolating sweep, point by
point as the reference defines them, batched over blocks of points.

Per point (mu, beta_t, dMu_t) lnPI is reweighted to mu and
Taylor-extrapolated in (dB, dDmu) = (beta_t - beta, dMu_t - dMu_ref):

    x'     = lnpi + a op + dB (r1 + mu op) + sum_q dd_q mq
             + [order 2] 1/2 (dB^2 h00 + 2 dB dd h01 + dd^2 h11)
    key'_k = key_k + dB sgB_k + sum_q dd_q sgM_qk
             + [order 2] 1/2 (dB^2 sgB2_k + 2 dB dd sgX_k + dd^2 sgM2_k)

with a = beta (mu - mu_ref) and the semigrand rows of derivs.py.  The
grand-canonical averages of the Taylor step are one constant over the
bins, which segmentation and the per-phase integrals cancel, so they are
left out.  The association of every sum is the kernels': segmentation
compares reweighted values, and a reordered sum moves them by rounding.
"""

from __future__ import annotations

import torch

from .derivs import DerivEngine
from .segment import key_rows, thermo_key
from .state import Hist, HistMeta

CHUNK_ELEMS = 2**27  # points a block holds, as a budget of points * phases * bins


def reweight_coeff(h: Hist, mu: torch.Tensor) -> torch.Tensor:
    """a = (mu - mu_ref) beta per point."""
    return (mu - h.curr_mu[0]) * h.curr_beta


def _blocks(n: int, per: int):
    return [slice(i, min(i + per, n)) for i in range(0, n, max(1, per))]


def _cat(outs: list) -> dict:
    return outs[0] if len(outs) == 1 else {k: torch.cat([o[k] for o in outs]) for k in outs[0]}


def mu_sweep(h: Hist, meta: HistMeta, mu: torch.Tensor) -> dict:
    """Reweight to each mu_1 of mu [B], segment, integrate."""
    key = key_rows(h.mom, meta)
    a = reweight_coeff(h, mu)
    outs = []
    for s in _blocks(mu.shape[0], CHUNK_ELEMS // (meta.max_phases * h.nbins)):
        x = h.lnpi + a[s, None] * h.op
        outs.append(thermo_key(x, key, meta, h.volume))
    return _cat(outs)


def mb_rows(eng: DerivEngine, h: Hist, meta: HistMeta, order: int):
    """The mu-independent rows: xrows [R, N] (r1, mq, then at order 2 h00,
    h01, h11) and krows [G, S+1, N] (key, sgB, sgM, then at order 2 sgB2,
    sgX, sgM2).  A key-row derivative that the
    moments are too short for (1 + order > max_order) is zero."""
    S = meta.nspec
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

    addrs = [(s, 1, 0, 0, 0) for s in range(S)] + [U]

    def group(o, fn):
        return torch.stack([fn(a) if 1 + o <= meta.max_order else torch.zeros_like(h.lnpi) for a in addrs])

    def cross(a):
        nq = (1, 1, 0, 0, 0)
        f = eng.m(eng._prod(nq, a)) - eng.m(nq) * eng.m(a)
        return beta * eng.sg_df_dB((nq, 0), (a, 0)) + f

    groups = [torch.stack([eng.m(a) for a in addrs]), group(1, lambda a: eng.sg_dX_dB(a, 0))]
    groups += [group(1, lambda a, q=q: eng.sg_dX_dMU(q, a)) for q in range(S - 1)]
    if order >= 2:
        groups.append(group(2, lambda a: eng.sg_d2X_dB2(a, 0)))
        if S == 2:
            groups += [group(2, cross), group(2, lambda a: eng.sg_d2X_dMU2(0, 0, a))]
    return torch.stack(xrows), torch.stack(groups)


def mb_targets(h: Hist, meta: HistMeta, betas: torch.Tensor, dmus: torch.Tensor, order: int) -> torch.Tensor:
    """Per-target scalars [A, T]: dB, dd (nspec 2), then at order 2 dB^2,
    2 dB dd, dd^2; betas [A], dmus [A or 1, S-1]."""
    A, S = betas.shape[0], meta.nspec
    dB = betas - h.curr_beta
    cols = [dB] + [dmus[:, q].expand(A) - (h.curr_mu[q + 1] - h.curr_mu[0]) for q in range(S - 1)]
    if order >= 2:
        cols.append(dB * dB)
        if S == 2:
            dd = cols[1]
            cols += [2.0 * dB * dd, dd * dd]
    return torch.stack(cols, dim=1)


def mb_chunk(h: Hist, meta: HistMeta, mu, a, xrows, krows, tg, order: int) -> dict:
    """The extrapolated thermo of mu [m] x the A targets of tg."""
    S, N = meta.nspec, h.nbins
    col = lambda j: tg[:, j][None, :, None]  # noqa: E731  a target scalar against [m, A, N]
    x = (h.lnpi + a[:, None] * h.op)[:, None, :]
    t = (xrows[0] + mu[:, None] * h.op)[:, None, :]
    B = mu.shape[0] * tg.shape[0]
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
    kp = kp[None].expand((mu.shape[0],) + kp.shape).reshape(B, S + 1, N)
    return thermo_key(xp, kp, meta, h.volume)


def mb_sweep(h: Hist, meta: HistMeta, mu, betas, dmus, order: int) -> dict:
    """The product sweep: every (mu [M], target [A]) pair; fields [M, A, ...]."""
    eng = DerivEngine(h, meta)
    xrows, krows = mb_rows(eng, h, meta, order)
    tg = mb_targets(h, meta, betas, dmus, order)
    a = reweight_coeff(h, mu)
    M, A = mu.shape[0], tg.shape[0]
    outs = [mb_chunk(h, meta, mu[s], a[s], xrows, krows, tg, order) for s in _blocks(M, CHUNK_ELEMS // (meta.max_phases * h.nbins * A))]
    return {k: v.reshape((M, A) + v.shape[1:]) for k, v in _cat(outs).items()}
