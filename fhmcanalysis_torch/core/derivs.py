"""Fluctuation-theory derivative kernels for Taylor extrapolation.

The semigrand (sg_*) and grand-canonical (gc_*) derivative calculus of the
reference (ntot/gc_hist.pyx:1241-2563) as plain PyTorch, method for method
the JAX package's ``core/derivs.py``.  Moment addresses are static Python
tuples; each distinct (address, op-power) sub-derivative is computed once
per engine and kept in a memo keyed exactly as the JAX engine keys it.

``DerivEngineN1`` configures the same machinery for the N_1 order
parameter (reference n1/gc_hist.pyx): the conjugate fields are the
*absolute* chemical potentials, there is no N_tot^n weighting, no
3rd-order beta support and no KE corrections.
"""

from __future__ import annotations

import torch

from .moments import mom_prod
from .state import Hist, HistMeta

Addr = tuple[int, int, int, int, int]

__all__ = ["DerivEngine", "DerivEngineN1", "warm_sg_memo", "zero_power", "check_order", "xni_addr"]


def zero_power(a: Addr) -> bool:
    """The address carries no power of N or U: its semigrand derivatives
    are zero rows."""
    return a[1] == 0 and a[3] == 0 and a[4] == 0


def check_order(a: Addr, max_order: int) -> None:
    """Raise where the moments are too short for a derivative of mom[a]."""
    mo = max_order
    if a[4] >= mo or a[3] >= mo or a[1] >= mo:
        raise ValueError("max_order too low to take this derivative: %s" % (a,))


def xni_addr(x_idx: Addr, i: int, max_order: int) -> Addr:
    """The address of the X*N_i moment of the semigrand fluctuation f(X,
    N_i) (the address cases of gc_hist.pyx:1683-1700, 1740-1757)."""
    mo = max_order
    if x_idx[0] == i and x_idx[1] + 1 <= mo:
        return (x_idx[0], x_idx[1] + 1, x_idx[2], x_idx[3], x_idx[4])
    if x_idx[2] == i and x_idx[3] + 1 <= mo:
        return (x_idx[0], x_idx[1], x_idx[2], x_idx[3] + 1, x_idx[4])
    if x_idx[1] == 0:
        return (i, 1, x_idx[2], x_idx[3], x_idx[4])
    if x_idx[3] == 0:
        return (x_idx[0], x_idx[1], i, 1, x_idx[4])
    if x_idx[0] == x_idx[2] and (x_idx[1] + x_idx[3] <= mo):
        return (x_idx[0], x_idx[1] + x_idx[3], i, 1, x_idx[4])
    raise ValueError("max_order too low to take this derivative")


def warm_sg_memo(h: Hist, meta, order: int = 2) -> dict:
    """Semigrand memo entries shared across reweights of one histogram.

    sg_* rows depend only on the mom tensor, beta_ref and the rigid dMu,
    not on the reweight mu_1, so a batched driver warms one base engine
    and seeds every per-mu engine via ``eng._memo.update(...)``.  gc_*
    entries are mu-dependent and left out."""
    base = DerivEngine(h, meta)
    base.dBMU(False)
    if order >= 2:
        base.dBMU2(False)
    return {k: v for k, v in base._memo.items() if k[0].startswith("sg")}


class DerivEngine:
    """Derivative kernels over one histogram state (f64 tensors on the
    Hist's device)."""

    def __init__(self, h: Hist, meta: HistMeta):
        self.lnpi = h.lnpi
        self.mom = h.mom
        self.op = h.op
        self.meta = meta
        self.nbins = h.lnpi.shape[-1]
        # leading state axes of lnpi: one state per row, as ops.reweight(h,
        # mu[T]) returns them (moments, op and beta may be shared).  Each
        # state's mu_i and beta become a column [..., 1] and each gc
        # average a sum over the bins only, so a Taylor series of T states
        # is one pass of tensor operations, row t that of state t alone.
        self.batch = tuple(h.lnpi.shape[:-1])
        self.vshape = self.batch + (self.nbins,)
        self.mu = h.curr_mu.movedim(-1, 0)[..., None] if self.batch else h.curr_mu
        self.beta = h.curr_beta[..., None] if self.batch else h.curr_beta
        # probability weights shared by every gc average
        self.prob = torch.exp(h.lnpi)
        self.sum_prob = torch.sum(self.prob, dim=-1, keepdim=bool(self.batch))
        self._memo = {}

    # ---------- helpers ----------

    def _zeros(self, shape=None):
        return self.lnpi.new_zeros(self.nbins if shape is None else shape)

    def _stack(self, rows, dim: int = 0):
        """torch.stack of rows over the bins, each broadcast to the states'
        [..., N] (a row of shared moments has no state axis)."""
        return torch.stack([r.expand(self.vshape) for r in rows], dim)

    def m(self, a: Addr):
        """One moment row: f64[..., N]."""
        return self.mom[..., a[0], a[1], a[2], a[3], a[4], :]

    def opn(self, n: int):
        return self.op**n if n else 1.0

    def X(self, a: Addr, n: int = 0):
        """mom[a] * op^n."""
        x = self.m(a)
        return x * self.op**n if n else x

    def _prod(self, x: Addr, y: Addr) -> Addr:
        return mom_prod(tuple(x), tuple(y), self.meta.nspec, self.meta.max_order)

    def _memoized(self, key, fn):
        if key not in self._memo:
            self._memo[key] = fn()
        return self._memo[key]

    def _xni(self, x_idx: Addr, i: int):
        """The X*N_i moment row of the semigrand fluctuation f(X, N_i)."""
        return self.m(xni_addr(x_idx, i, self.meta.max_order))

    # ---------- grand-canonical averages & fluctuations ----------

    def gc_ave_v(self, a):
        """<a> under P ~ exp(lnPI).  (gc_hist.pyx:1338-1357)"""
        return torch.sum(a * self.prob, dim=-1, keepdim=bool(self.batch)) / self.sum_prob

    def gc_ave_i(self, x_idx: Addr):
        """<mom[x]>.  (gc_hist.pyx:1359-1380)"""
        return self.gc_ave_v(self.m(x_idx))

    def gc_fluct_vv(self, a, b):
        """f(a,b) = <ab> - <a><b>.  (gc_hist.pyx:1241-1263)"""
        return self.gc_ave_v(a * b) - self.gc_ave_v(a) * self.gc_ave_v(b)

    def gc_fluct_vi(self, a, y_idx: Addr):
        """f(a, mom[y]).  (gc_hist.pyx:1265-1287)"""
        return self.gc_fluct_vv(a, self.m(y_idx))

    def gc_fluct_ii(self, x_idx: Addr, y_idx: Addr):
        """f(mom[x], mom[y]) via the product-address moment.
        (gc_hist.pyx:1313-1336)"""
        z = self._prod(x_idx, y_idx)
        return self.gc_ave_i(z) - self.gc_ave_i(tuple(x_idx)) * self.gc_ave_i(tuple(y_idx))

    # ---------- grand-canonical beta derivatives (scalars) ----------

    def gc_dX_dB(self, x_idx: Addr, n: int = 0):
        """d<X>/dB with X = mom[x]*op^n; KE-corrected.  (gc_hist.pyx:1382-1418)"""
        x_idx = tuple(x_idx)

        def build():
            X = self.X(x_idx, n)
            der = self.mu[0] * self.gc_fluct_vv(X, self.op)
            der = der - self.gc_fluct_vi(X, (0, 0, 0, 0, 1))
            for i in range(self.meta.nspec):
                der = der + (self.mu[i] - self.mu[0]) * self.gc_fluct_vi(X, (i, 1, 0, 0, 0))
            if self.meta.used_ke and x_idx[4] > 0:
                RUN = self.X((x_idx[0], x_idx[1], x_idx[2], x_idx[3], x_idx[4] - 1), n + 1)
                der = der - 1.5 * x_idx[4] / (self.beta * self.beta) * self.gc_ave_v(RUN)
            return der

        return self._memoized(("gc_dB", x_idx, n), build)

    def gc_df_dB_ii(self, x_idx_t, y_idx_t):
        """d/dB of f(<x>,<y>) for two moment addresses.  (gc_hist.pyx:1461-1486)"""
        x_idx, nx = x_idx_t
        y_idx, ny = y_idx_t
        z = self._prod(x_idx, y_idx)
        X = self.X(tuple(x_idx), nx)
        Y = self.X(tuple(y_idx), ny)
        return (
            self.gc_dX_dB(z, nx + ny)
            - self.gc_ave_v(X) * self.gc_dX_dB(tuple(y_idx), ny)
            - self.gc_ave_v(Y) * self.gc_dX_dB(tuple(x_idx), nx)
        )

    def gc_df_dB_in(self, x_idx_t, n: int = 0):
        """d/dB of f(<x>, <op^n>).  (gc_hist.pyx:1488-1513)"""
        x_idx, nx = x_idx_t
        x_idx = tuple(x_idx)
        X = self.X(x_idx, nx)
        Y = self.X((0, 0, 0, 0, 0), n)
        return (
            self.gc_dX_dB(x_idx, n + nx)
            - self.gc_ave_v(X) * self.gc_dX_dB((0, 0, 0, 0, 0), n)
            - self.gc_ave_v(Y) * self.gc_dX_dB(x_idx, nx)
        )

    def gc_d2X_dB2(self, x_idx: Addr, n: int = 0):
        """d2<X>/dB2; KE-corrected.  (gc_hist.pyx:1420-1459)"""
        x_idx = tuple(x_idx)

        def build():
            der = self.mu[0] * self.gc_df_dB_in((x_idx, n), 1)
            der = der - self.gc_df_dB_ii((x_idx, n), ((0, 0, 0, 0, 1), 0))
            for i in range(self.meta.nspec):
                der = der + (self.mu[i] - self.mu[0]) * self.gc_df_dB_ii((x_idx, n), ((i, 1, 0, 0, 0), 0))
            if self.meta.used_ke and x_idx[4] > 0:
                y_idx = (x_idx[0], x_idx[1], x_idx[2], x_idx[3], x_idx[4] - 1)
                ave_RUN = self.gc_ave_v(self.X(y_idx, n + 1))
                a = -2.0 / self.beta * ave_RUN
                b = self.gc_dX_dB(y_idx, n + 1)
                der = der - 1.5 * x_idx[4] / (self.beta * self.beta) * (a + b)
            return der

        return self._memoized(("gc_dB2", x_idx, n), build)

    # ---------- semigrand derivatives (vectors over N) ----------

    def sg_dX_dB(self, x_idx: Addr, n: int = 0):
        """d<X>_N/dB in the semigrand (fixed-N) ensemble.  (gc_hist.pyx:1660-1722)"""
        x_idx = tuple(x_idx)

        def build():
            if zero_power(x_idx):
                return self._zeros()
            check_order(x_idx, self.meta.max_order)
            opn = self.opn(n)
            f_XU = self.m((x_idx[0], x_idx[1], x_idx[2], x_idx[3], x_idx[4] + 1)) * opn - self.m(x_idx) * opn * self.m(
                (0, 0, 0, 0, 1)
            )
            der = -f_XU
            for i in range(self.meta.nspec):
                XNi = self._xni(x_idx, i) * opn
                f_XNi = XNi - self.m(x_idx) * opn * self.m((i, 1, 0, 0, 0))
                der = der + (self.mu[i] - self.mu[0]) * f_XNi
            if self.meta.used_ke and x_idx[4] > 0:
                RU = self.m((x_idx[0], x_idx[1], x_idx[2], x_idx[3], x_idx[4] - 1)) * opn
                der = der - 1.5 * x_idx[4] / (self.beta * self.beta) * self.op * RU
            return der

        return self._memoized(("sg_dB", x_idx, n), build)

    def sg_dX_dMU(self, q: int, x_idx: Addr):
        """d<X>_N/d(dMu_q), q indexes species 2..S.  (gc_hist.pyx:1724-1774)"""
        x_idx = tuple(x_idx)

        def build():
            if zero_power(x_idx):
                return self._zeros()
            check_order(x_idx, self.meta.max_order)
            i = q + 1
            return self.beta * (self._xni(x_idx, i) - self.m(x_idx) * self.m((i, 1, 0, 0, 0)))

        return self._memoized(("sg_dMU", q, x_idx), build)

    def sg_df_dB(self, x_idx_t, y_idx_t):
        """d/dB of the semigrand fluctuation f(x, y).  (gc_hist.pyx:1914-1941)"""
        x_idx, nx = x_idx_t
        y_idx, ny = y_idx_t
        z = self._prod(x_idx, y_idx)
        return (
            self.sg_dX_dB(z, nx + ny)
            - self.X(tuple(x_idx), nx) * self.sg_dX_dB(tuple(y_idx), ny)
            - self.X(tuple(y_idx), ny) * self.sg_dX_dB(tuple(x_idx), nx)
        )

    def sg_df_dMU(self, j: int, x_idx: Addr, y_idx: Addr):
        """d/d(dMu_j) of f(x, y).  (gc_hist.pyx:1943-1966)"""
        z = self._prod(x_idx, y_idx)
        return (
            self.sg_dX_dMU(j, z)
            - self.m(tuple(x_idx)) * self.sg_dX_dMU(j, tuple(y_idx))
            - self.m(tuple(y_idx)) * self.sg_dX_dMU(j, tuple(x_idx))
        )

    def sg_d2X_dB2(self, x_idx: Addr, n: int = 0):
        """d2<X>_N/dB2; KE-corrected.  (gc_hist.pyx:1776-1827)"""
        x_idx = tuple(x_idx)

        def build():
            if zero_power(x_idx):
                return self._zeros()
            check_order(x_idx, self.meta.max_order)
            der = -self.sg_df_dB((x_idx, n), ((0, 0, 0, 0, 1), 0))
            for i in range(self.meta.nspec):
                der = der + (self.mu[i] - self.mu[0]) * self.sg_df_dB((x_idx, n), ((i, 1, 0, 0, 0), 0))
            if self.meta.used_ke and x_idx[4] > 0:
                y_idx = (x_idx[0], x_idx[1], x_idx[2], x_idx[3], x_idx[4] - 1)
                RU = self.m(y_idx) * self.opn(n)
                a = -2.0 / self.beta * RU
                b = self.sg_dX_dB(y_idx, n)
                der = der + (-1.5) * x_idx[4] * self.op / (self.beta * self.beta) * (a + b)
            return der

        return self._memoized(("sg_dB2", x_idx, n), build)

    def sg_d2X_dMU2(self, q: int, r: int, x_idx: Addr):
        """d2<X>_N/d(dMu_q)d(dMu_r).  (gc_hist.pyx:1829-1868)"""
        x_idx = tuple(x_idx)
        if zero_power(x_idx):
            return self._zeros()
        check_order(x_idx, self.meta.max_order)
        return self.beta * self.sg_df_dMU(q, x_idx, (r + 1, 1, 0, 0, 0))

    def sg_d2f_dB2(self, x_idx_t, y_idx_t):
        """d2/dB2 of f(x, y); the reference double-counts the cross term
        (gc_hist.pyx:1993), reproduced for parity."""
        x_idx, nx = x_idx_t
        y_idx, ny = y_idx_t
        z = self._prod(x_idx, y_idx)
        cross = self.sg_dX_dB(tuple(x_idx), nx) * self.sg_dX_dB(tuple(y_idx), ny)
        return (
            self.sg_d2X_dB2(z, nx + ny)
            - self.X(tuple(x_idx), nx) * self.sg_d2X_dB2(tuple(y_idx), ny)
            - cross
            - self.X(tuple(y_idx), ny) * self.sg_d2X_dB2(tuple(x_idx), nx)
            - cross
        )

    def sg_d3X_dB3(self, x_idx: Addr, n: int = 0):
        """d3<X>_N/dB3; no KE corrections.  (gc_hist.pyx:1870-1912)"""
        x_idx = tuple(x_idx)
        if zero_power(x_idx):
            return self._zeros()
        check_order(x_idx, self.meta.max_order)
        der = -self.sg_d2f_dB2((x_idx, n), ((0, 0, 0, 0, 1), 0))
        for i in range(self.meta.nspec):
            der = der + (self.mu[i] - self.mu[0]) * self.sg_d2f_dB2((x_idx, n), ((i, 1, 0, 0, 0), 0))
        if self.meta.used_ke:
            raise ValueError("No KE correction implemented for sg_d3X_dB3")
        return der

    # ---------- Taylor coefficient assembly ----------

    def _mom_loop(self, order: int, fn):
        """A moments-shaped tensor holding fn(addr) where the gate
        j+m+p+order <= max_order holds and zero elsewhere, stacked from
        per-address rows."""
        meta = self.meta
        zero = self._zeros()
        rows = []
        for i in range(meta.nspec):
            for j in range(meta.mo1):
                for k in range(meta.nspec):
                    for mm in range(meta.mo1):
                        for p in range(meta.mo1):
                            rows.append(fn((i, j, k, mm, p)) if j + mm + p + order <= meta.max_order else zero)
        return self._stack(rows, -2).reshape(self.batch + meta.mom_shape(self.nbins))

    def _mom_zeros(self, lead=()):
        return self._zeros(tuple(lead) + self.batch + self.meta.mom_shape(self.nbins))

    def dB(self, skip_mom: bool = False):
        """First-order beta Taylor coefficients.  (gc_hist.pyx:2114-2165)"""
        ave_u = self.gc_ave_i((0, 0, 0, 0, 1))
        ave_ntot = 0.0
        dlnpi = self._zeros()
        for i in range(self.meta.nspec):
            ave_ni = self.gc_ave_i((i, 1, 0, 0, 0))
            ave_ntot = ave_ntot + ave_ni
            dlnpi = dlnpi + (self.mu[i] - self.mu[0]) * (self.m((i, 1, 0, 0, 0)) - ave_ni)
        dlnpi = dlnpi + self.mu[0] * (self.op - ave_ntot)
        dlnpi = dlnpi - (self.m((0, 0, 0, 0, 1)) - ave_u)
        dm = self._mom_zeros() if skip_mom else self._mom_loop(1, lambda a: self.sg_dX_dB(a, 0))
        return dlnpi, dm

    def dB2(self, skip_mom: bool = False):
        """Second-order beta coefficients.  (gc_hist.pyx:2167-2206)"""
        d2 = self._zeros()
        for i in range(self.meta.nspec):
            d2 = d2 + (self.mu[i] - self.mu[0]) * (self.sg_dX_dB((i, 1, 0, 0, 0), 0) - self.gc_dX_dB((i, 1, 0, 0, 0), 0))
        d2 = d2 + self.mu[0] * (-self.gc_dX_dB((0, 0, 0, 0, 0), 1))
        d2 = d2 - (self.sg_dX_dB((0, 0, 0, 0, 1), 0) - self.gc_dX_dB((0, 0, 0, 0, 1), 0))
        dm2 = self._mom_zeros() if skip_mom else self._mom_loop(2, lambda a: self.sg_d2X_dB2(a, 0))
        return d2, dm2

    def dB3(self, skip_mom: bool = False):
        """Third-order beta coefficients; binary/pure only, no KE.
        (gc_hist.pyx:2208-2252)"""
        if self.meta.used_ke:
            raise ValueError("KE corrections not implemented for 3rd order beta extrapolation")
        d3 = self._zeros()
        for i in range(self.meta.nspec):
            d3 = d3 + (self.mu[i] - self.mu[0]) * (self.sg_d2X_dB2((i, 1, 0, 0, 0), 0) - self.gc_d2X_dB2((i, 1, 0, 0, 0), 0))
        d3 = d3 + self.mu[0] * (-self.gc_d2X_dB2((0, 0, 0, 0, 0), 1))
        d3 = d3 - (self.sg_d2X_dB2((0, 0, 0, 0, 1), 0) - self.gc_d2X_dB2((0, 0, 0, 0, 1), 0))
        dm3 = self._mom_zeros() if skip_mom else self._mom_loop(3, lambda a: self.sg_d3X_dB3(a, 0))
        return d3, dm3

    def dMU(self, skip_mom: bool = False):
        """First-order dMu coefficients, one row per species 2..S.
        (gc_hist.pyx:2342-2387)"""
        S1 = self.meta.nspec - 1
        rows = [self.beta * (self.m((i + 1, 1, 0, 0, 0)) - self.gc_ave_i((i + 1, 1, 0, 0, 0))) for i in range(S1)]
        dlnpi = self._stack(rows) if rows else self._zeros((0,) + self.vshape)
        if skip_mom or not S1:
            dm = self._mom_zeros((S1,))
        else:
            dm = torch.stack([self._mom_loop(1, lambda a, q=q: self.sg_dX_dMU(q, a)) for q in range(S1)])
        return dlnpi, dm

    def _dmu_block(self, i: int, j: int):
        """beta^2 (f_N(N_i, N_j) - f_GC(N_i, N_j)), species 2..S
        (gc_hist.pyx:2409-2413, 2509-2513)."""
        f = self.m((i + 1, 1, j + 1, 1, 0)) - self.m((i + 1, 1, j + 1, 0, 0)) * self.m((i + 1, 0, j + 1, 1, 0))
        return self.beta**2 * (f - self.gc_fluct_ii((i + 1, 1, 0, 0, 0), (j + 1, 1, 0, 0, 0)))

    def dMU2(self, skip_mom: bool = False):
        """Second-order dMu Hessian.  (gc_hist.pyx:2389-2434)"""
        S1 = self.meta.nspec - 1
        if not S1:
            return self._zeros((0, 0) + self.vshape), self._mom_zeros((0, 0))
        H = torch.stack([self._stack([self._dmu_block(i, j) for j in range(S1)]) for i in range(S1)])
        if skip_mom:
            Hm = self._mom_zeros((S1, S1))
        else:
            Hm = torch.stack(
                [torch.stack([self._mom_loop(2, lambda a, q=q, r=r: self.sg_d2X_dMU2(q, r, a)) for r in range(S1)]) for q in range(S1)]
            )
        return H, Hm

    def dBMU(self, skip_mom: bool = False):
        """Joint (beta, dMu) first-order coefficients; row 0 = beta, rows
        1..S-1 = dMu.  (gc_hist.pyx:2436-2482)"""
        S = self.meta.nspec
        dlnpi_b, dm_b = self.dB(skip_mom)
        rows = [dlnpi_b] + [self.beta * (self.m((i, 1, 0, 0, 0)) - self.gc_ave_i((i, 1, 0, 0, 0))) for i in range(1, S)]
        mrows = [dm_b]
        for q in range(1, S):
            mrows.append(self._mom_zeros() if skip_mom else self._mom_loop(1, lambda a, q=q: self.sg_dX_dMU(q - 1, a)))
        return self._stack(rows), torch.stack(mrows)

    def dBMU2(self, skip_mom: bool = False):
        """Joint (beta, dMu) Hessian with beta-dMu cross terms.
        (gc_hist.pyx:2484-2563)"""
        S = self.meta.nspec
        H = [[self._zeros() for _ in range(S)] for _ in range(S)]
        Hm = [[None] * S for _ in range(S)]  # None: a zero block

        # dMu block
        for i in range(S - 1):
            for j in range(S - 1):
                H[i + 1][j + 1] = self._dmu_block(i, j)
        if not skip_mom:
            for q in range(S - 1):
                for r in range(S - 1):
                    Hm[q + 1][r + 1] = self._mom_loop(2, lambda a, q=q, r=r: self.sg_d2X_dMU2(q, r, a))

        # beta block
        d2lnpi, d2m = self.dB2(skip_mom)
        H[0][0] = d2lnpi
        Hm[0][0] = d2m

        # beta-dMu cross terms
        for q in range(1, S):
            tmp = self.m((q, 1, 0, 0, 0)) - self.gc_ave_i((q, 1, 0, 0, 0))
            tmp = tmp + self.beta * (self.sg_dX_dB((q, 1, 0, 0, 0), 0) - self.gc_dX_dB((q, 1, 0, 0, 0), 0))
            H[q][0] = tmp
            H[0][q] = tmp

        if not skip_mom:
            for q in range(1, S):

                def cross(a, q=q):
                    z = self._prod((q, 1, 0, 0, 0), a)
                    f = self.m(z) - self.m((q, 1, 0, 0, 0)) * self.m(a)
                    # NB: reference keeps beta OUTSIDE the f term
                    # (gc_hist.pyx:2554 and the recorded fix note at :2555)
                    return self.beta * self.sg_df_dB(((q, 1, 0, 0, 0), 0), (a, 0)) + f

                x = self._mom_loop(2, cross)
                Hm[q][0] = x
                Hm[0][q] = x

        zero = self._mom_zeros()
        Hm = torch.stack([torch.stack([zero if b is None else b for b in row]) for row in Hm])
        return torch.stack([self._stack(row) for row in H]), Hm


class DerivEngineN1(DerivEngine):
    """Derivative kernels for the N_1 order parameter.

    Differences from the N_tot engine (reference n1/gc_hist.pyx):
    conjugate fields are absolute chemical potentials mu_1..mu_S (the
    species-1 term enters via the order parameter N_1 itself), no N_tot^n
    weighting anywhere, no KE corrections, no 3rd-order beta.  ``h.op``
    must hold N_1.
    """

    def gc_dX_dB(self, x_idx: Addr, n: int = 0):
        """d<mom[x]>/dB; the n argument is ignored as in the reference
        (n1/gc_hist.pyx:1336-1367)."""
        x_idx = tuple(x_idx)

        def build():
            X = self.m(x_idx)
            der = self.mu[0] * self.gc_fluct_vi(X, (0, 1, 0, 0, 0))
            der = der - self.gc_fluct_vi(X, (0, 0, 0, 0, 1))
            for i in range(1, self.meta.nspec):
                der = der + self.mu[i] * self.gc_fluct_vi(X, (i, 1, 0, 0, 0))
            return der

        return self._memoized(("gc_dB_n1", x_idx), build)

    def sg_dX_dB(self, x_idx: Addr, n: int = 0):
        """d<mom[x]>_N1/dB with absolute-mu conjugates
        (n1/gc_hist.pyx:790-845)."""
        x_idx = tuple(x_idx)

        def build():
            if zero_power(x_idx):
                return self._zeros()
            check_order(x_idx, self.meta.max_order)
            f_XU = self.m((x_idx[0], x_idx[1], x_idx[2], x_idx[3], x_idx[4] + 1)) - self.m(x_idx) * self.m((0, 0, 0, 0, 1))
            der = -f_XU
            for i in range(1, self.meta.nspec):
                f_XNi = self._xni(x_idx, i) - self.m(x_idx) * self.m((i, 1, 0, 0, 0))
                der = der + self.mu[i] * f_XNi
            return der

        return self._memoized(("sg_dB_n1", x_idx), build)

    def sg_d2X_dB2(self, x_idx: Addr, n: int = 0):
        """d2<mom[x]>_N1/dB2 (n1/gc_hist.pyx:1392-1438)."""
        x_idx = tuple(x_idx)

        def build():
            if zero_power(x_idx):
                return self._zeros()
            check_order(x_idx, self.meta.max_order)
            der = -self.sg_df_dB((x_idx, 0), ((0, 0, 0, 0, 1), 0))
            for i in range(1, self.meta.nspec):
                der = der + self.mu[i] * self.sg_df_dB((x_idx, 0), ((i, 1, 0, 0, 0), 0))
            return der

        return self._memoized(("sg_dB2_n1", x_idx), build)

    def sg_d3X_dB3(self, x_idx: Addr, n: int = 0):
        raise NotImplementedError("3rd-order beta extrapolation is not defined for the N_1 order parameter")

    def dB(self, skip_mom: bool = False):
        """First-order beta coefficients with absolute mus
        (n1/gc_hist.pyx:739-788)."""
        ave_u = self.gc_ave_i((0, 0, 0, 0, 1))
        dlnpi = self._zeros()
        for i in range(self.meta.nspec):
            dlnpi = dlnpi + self.mu[i] * (self.m((i, 1, 0, 0, 0)) - self.gc_ave_i((i, 1, 0, 0, 0)))
        dlnpi = dlnpi - (self.m((0, 0, 0, 0, 1)) - ave_u)
        dm = self._mom_zeros() if skip_mom else self._mom_loop(1, lambda a: self.sg_dX_dB(a))
        return dlnpi, dm

    def dB2(self, skip_mom: bool = False):
        """Second-order beta coefficients (n1/gc_hist.pyx:1295-1334)."""
        d2 = self._zeros()
        for i in range(1, self.meta.nspec):
            d2 = d2 + self.mu[i] * (self.sg_dX_dB((i, 1, 0, 0, 0)) - self.gc_dX_dB((i, 1, 0, 0, 0)))
        d2 = d2 + self.mu[0] * (-self.gc_dX_dB((0, 1, 0, 0, 0)))
        d2 = d2 - (self.sg_dX_dB((0, 0, 0, 0, 1)) - self.gc_dX_dB((0, 0, 0, 0, 1)))
        dm2 = self._mom_zeros() if skip_mom else self._mom_loop(2, lambda a: self.sg_d2X_dB2(a))
        return d2, dm2

    def dB3(self, skip_mom: bool = False):
        raise NotImplementedError("3rd-order beta extrapolation is not defined for the N_1 order parameter")

    # dBMU / dBMU2 are inherited verbatim: their structure is identical and
    # every sub-kernel they call dispatches to the overrides above
    # (n1/gc_hist.pyx:691-738, 954-1032).
