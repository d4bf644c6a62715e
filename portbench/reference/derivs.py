"""The semigrand (fixed-N) derivative rows of the Taylor extrapolation in
(beta, dMu): the reference's fluctuation calculus (FHMCAnalysis
ntot/gc_hist.pyx:1660-1868) as plain PyTorch, a frozen copy of the rows the
extrapolating sweeps need.  The grand-canonical averages are left out:
each enters the extrapolated lnPI as one constant over the bins, which
the segmentation and the per-phase integrals cancel.
"""

from __future__ import annotations

from .moments import mom_prod
from .state import Hist, HistMeta

Addr = tuple[int, int, int, int, int]


class DerivEngine:
    """The semigrand derivative rows of one histogram state."""

    def __init__(self, h: Hist, meta: HistMeta):
        self.mom = h.mom
        self.op = h.op
        self.meta = meta
        self.nbins = h.lnpi.shape[-1]
        self.mu = h.curr_mu
        self.beta = h.curr_beta
        self._memo = {}
        self.read = set()  # the moment rows read, for the byte counts of the rooflines

    def _zeros(self):
        return self.op.new_zeros(self.nbins)

    def m(self, a: Addr):
        """One moment row [N]."""
        self.read.add(tuple(a))
        return self.mom[a[0], a[1], a[2], a[3], a[4]]

    def opn(self, n: int):
        return self.op**n if n else 1.0

    def X(self, a: Addr, n: int = 0):
        """mom[a] * op^n."""
        x = self.m(a)
        return x * self.op**n if n else x

    def _prod(self, x: Addr, y: Addr) -> Addr:
        return mom_prod(tuple(x), tuple(y), self.meta.nspec, self.meta.max_order)

    def _zero_power(self, a: Addr) -> bool:
        return a[1] == 0 and a[3] == 0 and a[4] == 0

    def _check_order(self, a: Addr):
        mo = self.meta.max_order
        if a[4] >= mo or a[3] >= mo or a[1] >= mo:
            raise ValueError("max_order too low to take this derivative: %s" % (a,))

    def _memoized(self, key, fn):
        if key not in self._memo:
            self._memo[key] = fn()
        return self._memo[key]

    def _xni(self, x_idx: Addr, i: int):
        """The X*N_i moment row of the semigrand fluctuation f(X, N_i)
        (the address cases of gc_hist.pyx:1683-1700, 1740-1757)."""
        mo = self.meta.max_order
        if x_idx[0] == i and x_idx[1] + 1 <= mo:
            return self.m((x_idx[0], x_idx[1] + 1, x_idx[2], x_idx[3], x_idx[4]))
        if x_idx[2] == i and x_idx[3] + 1 <= mo:
            return self.m((x_idx[0], x_idx[1], x_idx[2], x_idx[3] + 1, x_idx[4]))
        if x_idx[1] == 0:
            return self.m((i, 1, x_idx[2], x_idx[3], x_idx[4]))
        if x_idx[3] == 0:
            return self.m((x_idx[0], x_idx[1], i, 1, x_idx[4]))
        if x_idx[0] == x_idx[2] and (x_idx[1] + x_idx[3] <= mo):
            return self.m((x_idx[0], x_idx[1] + x_idx[3], i, 1, x_idx[4]))
        raise ValueError("max_order too low to take this derivative")

    def sg_dX_dB(self, x_idx: Addr, n: int = 0):
        """d<X>_N/dB in the semigrand (fixed-N) ensemble.  (gc_hist.pyx:1660-1722)"""
        x_idx = tuple(x_idx)

        def build():
            if self._zero_power(x_idx):
                return self._zeros()
            self._check_order(x_idx)
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
            if self._zero_power(x_idx):
                return self._zeros()
            self._check_order(x_idx)
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
            if self._zero_power(x_idx):
                return self._zeros()
            self._check_order(x_idx)
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
        if self._zero_power(x_idx):
            return self._zeros()
        self._check_order(x_idx)
        return self.beta * self.sg_df_dMU(q, x_idx, (r + 1, 1, 0, 0, 0))
