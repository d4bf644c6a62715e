"""Phase-equilibrium solvers: the port of ``fhmcanalysis_tpu/core/solve.py``.

``phase_eq_error`` is the reference objective (gc_hist.pyx:2570-2630):
reweight -> (optional) joint Taylor extrapolation -> segmentation ->
min-over-phase-pairs squared free-energy difference, width-filtered.  On
CUDA tensors it runs on kernel K1 (``cuda_sweep``) without extrapolation
and on K2's paired mode (``cuda_mb``, one target per mu) with it, both at
``props=False``; on the CPU, or with ``engine="torch"``, on their plain
versions (``pipeline.mu_sweep_body``, ``pipeline._mb_paired_body``).  The
rows that depend on neither mu nor the target (K1's key rows, K2's rows
from the row former or ``_mb_rows`` on the CPU, ``_mb_targets``) are
built once per solve; a solver step changes only the (mu, target) pairs.

``nelder_mead_1d`` has scipy.optimize.fmin's 1-D update rules (the
reference's solver call, gc_hist.pyx:653), batched over targets: the JAX
package runs one ``lax.while_loop`` under ``vmap``, where a finished
lane's carry stays frozen; here each target keeps its own simplex and an
``active`` flag, every candidate of every target goes to the objective in
one call, and a masked step leaves a finished target unchanged, so the
host tests for the end only every ``SYNC_EVERY`` steps.

Like the sweeps, lnPI is segmented as reweighted, without the
normalisation JAX's ``reweight`` applies: fe and the bounds are invariant
under lnpi -> lnpi + c (tests/test_torch_solve.py holds segmentation equal
to JAX's on every mu the solver evaluates).
"""

from __future__ import annotations

import torch

from ..utils import profiling
from . import cuda_mb, cuda_sweep, pipeline
from .extrap import temp_dmu_extrap
from .ops import reweight
from .segment import key_rows
from .state import Hist, HistMeta

__all__ = ["phase_eq_error", "nelder_mead_1d", "find_phase_eq_state", "trace_coexistence"]

DEFAULT_ERR2 = 100.0  # reference default when <2 phases qualify (gc_hist.pyx:2614)
# Masked Nelder-Mead steps between the host's stopping tests, read at each
# call: each test waits for the card.  The coexistence phase of
# chip_smoke.py times the coex573 trace at k = 1 to 32: k = 1 is the
# slowest, and the host's noise does not separate k = 2 to 32 (PERF.md).
# k = 8 is kept because a solve that ends between tests wastes at most 7
# masked steps.
SYNC_EVERY = 8


def _min_pair_err2(seg: dict, pairs: torch.Tensor, min_width: int) -> torch.Tensor:
    """min over the phase pairs (i, j) = pairs[:, n] of (dF.E./kT)^2 per
    point, width-filtered; DEFAULT_ERR2 where fewer than two phases qualify
    or the segmentation is invalid (the reference raises there,
    gc_hist.pyx:403-415)."""
    fe, mask = seg["fe"], seg["mask"]
    i, j = pairs
    width_ok = ((seg["right"] - seg["left"]) >= min_width) & mask
    diff2 = (fe[:, i] - fe[:, j]) ** 2
    errs = torch.where(width_ok[:, i] & width_ok[:, j], diff2, DEFAULT_ERR2)
    err2 = errs.amin(-1)
    return torch.where((seg["n_phases"] <= 1) | ~seg["valid"], DEFAULT_ERR2, err2)


class _Objective:
    """phase_eq_error over a batch of (mu, target) points with the rows
    built once: targets are (betas[t], dmus[t]) with extrapolation (K2's
    paired mode or its plain version); without it there are none (K1)."""

    def __init__(self, h: Hist, meta: HistMeta, betas, dmus, order: int, min_width: int, extrapolate: bool, collect, engine: str, props_rows: bool = False):
        self.kernel = pipeline._on_kernel(engine, h.device, collect)
        self.h, self.meta, self.order, self.min_width, self.extrapolate, self.collect = h, meta, order, min_width, extrapolate, collect
        P = meta.max_phases
        self.pairs = torch.triu_indices(P, P, 1, device=h.device)
        if extrapolate:
            pipeline._check_mb(meta, order)
            self.tg = pipeline._mb_targets(h, meta, betas, dmus, order)
            self.xrows, self.krows = pipeline._rows(h, meta, order, props_rows, False, self.kernel)
        elif self.kernel:
            self.keys = key_rows(h.mom, meta).contiguous()
        self._rows = {}

    def segment(self, mu: torch.Tensor, tix: torch.Tensor, props: bool = False) -> dict:
        """The sweep dict of the points (mu[b], target tix[b]); tix is
        ignored without extrapolation."""
        h, meta = self.h, self.meta
        if not self.extrapolate:
            if not self.kernel:
                return pipeline.mu_sweep_body(h, meta, mu, props, self.collect)
            a = pipeline._reweight_coeff(h, mu).contiguous()
            return cuda_sweep.sweep_thermo(h.lnpi.contiguous(), h.op.contiguous(), self.keys, h.volume, a, meta.smooth, meta.max_phases, props, self.collect)
        a = pipeline._reweight_coeff(h, mu).contiguous()
        if not self.kernel:
            return pipeline._mb_paired_body(h, meta, mu, a, self.xrows, self.krows, self.tg, tix, self.order, props, self.collect)
        return cuda_mb.mb_sweep_thermo(
            h.lnpi.contiguous(), h.op.contiguous(), self.xrows, self.krows if props else None, h.volume, mu, a, self.tg,
            meta.nspec, meta.smooth, meta.max_phases, self.order, props, False, self.collect, tix=tix,
        )

    def __call__(self, mu: torch.Tensor, tix: torch.Tensor) -> torch.Tensor:
        return _min_pair_err2(self.segment(mu, tix), self.pairs, self.min_width)

    def on_targets(self, T: int):
        """f for nelder_mead_1d: a [k, T] tensor of mu values, column t
        target t's, to their errors; the target index of each shape is
        built once."""

        def f(x: torch.Tensor) -> torch.Tensor:
            k = x.shape[0]
            if k not in self._rows:
                self._rows[k] = torch.arange(T, dtype=torch.int32, device=x.device).repeat(k)
            return self(x.reshape(-1), self._rows[k]).reshape(x.shape)

        return f


def _f64(h: Hist, v) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float64, device=h.device)


def _ndim(h: Hist, v) -> int:
    return 0 if v is None else _f64(h, v).dim()


def _targets(h: Hist, beta, dmu, T: int = 1):
    """(betas [A], dmus [A, S-1]) from a beta (scalar or [A]) and a dMu
    ([S-1] or [A, S-1]), A the larger of their counts and T; defaults are
    the histogram's own."""
    beta = (h.curr_beta if beta is None else _f64(h, beta)).reshape(-1)
    dmu = (h.curr_mu[1:] - h.curr_mu[0]) if dmu is None else _f64(h, dmu)
    dmu = dmu if dmu.dim() == 2 else dmu[None]
    A = max(beta.shape[0], dmu.shape[0], T)
    return beta.expand(A), dmu.expand(A, h.curr_mu.shape[0] - 1)


def phase_eq_error(mu_guess, h: Hist, meta: HistMeta, beta=None, dmu=None, order: int = 1, min_width: int = 0, extrapolate: bool = False, collect=None, engine: str = "auto", *, tix=None):
    """Squared F.E./kT gap between the two closest phases at mu_1 = mu_guess.

    Parity: phase_eq_error (gc_hist.pyx:2570-2630, incl. its collect
    pass-through at :2612) and the JAX package's.  mu_guess is a scalar or
    a batch [B]; with ``extrapolate`` the targets are beta [A] (or a
    scalar) and dmu [A or 1, S-1] (or [S-1]), and point b is evaluated at
    target tix[b] (int, [B]; default: b when A == B, 0 when A == 1, else
    an error).  Without it beta and dmu are ignored.  Returns err^2 of
    mu_guess's shape.

    engine: "auto" follows the tensors' device (CUDA: K1, or K2's paired
    mode with extrapolate; CPU: their plain versions), "torch" forces the
    plain versions, "cuda" the kernels (raises for CPU tensors).
    """
    mu = _f64(h, mu_guess)
    B = mu.numel()
    betas, dmus = _targets(h, beta, dmu) if extrapolate else (None, None)
    A = 1 if betas is None else betas.shape[0]
    if tix is None:
        if A not in (1, B):
            raise ValueError(f"phase_eq_error: {B} mu values and {A} targets; pass tix to pair them")
        tix = torch.arange(B, device=h.device) if A == B else torch.zeros(B, dtype=torch.int64, device=h.device)
    tix = torch.as_tensor(tix, device=h.device).to(torch.int32).reshape(-1).expand(B).contiguous()
    obj = _Objective(h, meta, betas, dmus, order, min_width, extrapolate, collect, engine)
    return obj(mu.reshape(-1).contiguous(), tix).reshape(mu.shape)


def nelder_mead_1d(f, x0, xtol: float = 1e-4, ftol: float = 1e-4, maxiter: int = 100000):
    """1-D Nelder-Mead with scipy.optimize.fmin's update rules, over a
    batch of independent targets.

    rho=1, chi=2, psi=0.5, sigma=0.5; initial simplex [x0, 1.05*x0] (or
    0.00025 if x0 == 0); a target has converged when its simplex spread
    passes both xtol and ftol, and stops at maxiter steps.  x0 is a scalar
    or [T]; f maps a [k, T] tensor of points (column t target t's) to their
    values, so any elementwise function works.  Each step evaluates every
    target's five candidates in one call of f (the JAX package evaluates
    both branches of its lax.cond under vmap too) and picks with
    torch.where in JAX's order; a finished target's state stays frozen, so
    the host tests for the end every ``SYNC_EVERY`` steps and extra steps
    change nothing.

    Returns (x_best, f_best, n_iter, converged), each of x0's shape.
    """
    k = SYNC_EVERY
    if k < 1:
        raise ValueError(f"SYNC_EVERY must be >= 1, got {k}")
    x0 = torch.as_tensor(x0, dtype=torch.float64)
    shape = x0.shape
    x0 = x0.reshape(-1)
    x1 = torch.where(x0 != 0.0, 1.05 * x0, 0.00025)
    f01 = f(torch.stack([x0, x1]))
    f0, f1 = f01[0], f01[1]
    # order so that (a, fa) is best
    first = f0 <= f1
    a, b = torch.where(first, x0, x1), torch.where(first, x1, x0)
    fa, fb = torch.minimum(f0, f1), torch.maximum(f0, f1)
    it = torch.zeros(x0.shape, dtype=torch.int32, device=x0.device)
    cand = torch.empty((5,) + x0.shape, dtype=torch.float64, device=x0.device)

    def running(a, fa, b, fb, it):
        return (it < maxiter) & ~((torch.abs(b - a) <= xtol) & (torch.abs(fb - fa) <= ftol))

    while True:
        with profiling.span("fhmc.solver.steps"):
            for _ in range(k):
                act = running(a, fa, b, fb, it)
                # reflect worst (b) through best (a); expand; outside and inside
                # contraction; shrink toward a
                torch.sub(2.0 * a, b, out=cand[0])
                torch.sub(3.0 * a, 2.0 * b, out=cand[1])
                torch.sub(1.5 * a, 0.5 * b, out=cand[2])
                torch.add(0.5 * a, 0.5 * b, out=cand[3])
                torch.add(a, 0.5 * (b - a), out=cand[4])
                fr, fe, fc, fcc, fs = f(cand)
                xr, xe, xc, xcc, xs = cand
                ex_x, ex_f = torch.where(fe < fr, xe, xr), torch.where(fe < fr, fe, fr)
                out_x, out_f = torch.where(fc <= fr, xc, xs), torch.where(fc <= fr, fc, fs)
                in_x, in_f = torch.where(fcc < fb, xcc, xs), torch.where(fcc < fb, fcc, fs)
                outside = fr < fb
                co_x, co_f = torch.where(outside, out_x, in_x), torch.where(outside, out_f, in_f)
                expand = fr < fa
                nb, nfb = torch.where(expand, ex_x, co_x), torch.where(expand, ex_f, co_f)
                # re-sort the simplex, on running targets only
                better = nfb < fa
                na, nfa = torch.where(better, nb, a), torch.where(better, nfb, fa)
                nb2, nfb2 = torch.where(better, a, nb), torch.where(better, fa, nfb)
                a, fa = torch.where(act, na, a), torch.where(act, nfa, fa)
                b, fb = torch.where(act, nb2, b), torch.where(act, nfb2, fb)
                it = it + act.to(torch.int32)
        profiling.add("solver.steps", k)
        with profiling.span("fhmc.solver.test"):
            done = not bool(running(a, fa, b, fb, it).any())
        profiling.add("host_syncs")
        if done:
            break
    converged = (torch.abs(b - a) <= xtol) & (torch.abs(fb - fa) <= ftol)
    return a.reshape(shape), fa.reshape(shape), it.reshape(shape), converged.reshape(shape)


def _solve(obj: _Objective, x0: torch.Tensor, lnZ_tol: float):
    """Minimise obj over mu for each of x0's [T] targets.  The objective is
    (dFE)^2, so meeting |dFE| <= lnZ_tol (the BASELINE coexistence bar,
    stronger than scipy-fmin's ftol-on-err^2 semantics) needs the squared
    tolerance, as in the JAX package."""
    return nelder_mead_1d(obj.on_targets(x0.shape[0]), x0, xtol=1e-10, ftol=lnZ_tol**2)


def find_phase_eq_state(
    h: Hist,
    meta: HistMeta,
    lnZ_tol: float,
    mu_guess,
    beta=None,
    dmu=None,
    order: int = 1,
    min_width: int = 0,
    extrapolate: bool = False,
    full_mom: bool = True,
    collect=None,
    engine: str = "auto",
):
    """Locate mu_1 at phase coexistence; return the coexistence state.

    Parity flow: find_phase_eq (gc_hist.pyx:598-668) -- minimize
    phase_eq_error over mu_1, then reweight (+extrapolate with full
    moments unless not full_mom) at the solution.

    Batched where the JAX package is vmapped: mu_guess may be [T], and
    with ``extrapolate`` beta [T] and dmu [T, S-1] too (one solve per
    target, all in one Nelder-Mead); then every returned tensor, and every
    field of the returned Hist, has a leading [T] axis.

    Returns (Hist at coexistence, mu_star, err, converged).
    """
    mu0 = _f64(h, mu_guess).reshape(-1)
    batched = _ndim(h, mu_guess) > 0 or (extrapolate and (_ndim(h, beta) > 0 or _ndim(h, dmu) > 1))
    betas, dmus = _targets(h, beta, dmu, mu0.shape[0]) if extrapolate else (None, None)
    T = mu0.shape[0] if betas is None else betas.shape[0]
    obj = _Objective(h, meta, betas, dmus, order, min_width, extrapolate, collect, engine)
    mu_star, err, _, converged = _solve(obj, mu0.expand(T).contiguous(), lnZ_tol)

    if not batched:
        out = reweight(h, mu_star[0])
        if extrapolate:
            out = temp_dmu_extrap(out, meta, betas[0], dmus[0], order=order, skip_mom=not full_mom)
        return out, mu_star[0], err[0], converged[0]
    # the T states in one pass: reweight takes the batch, the paired
    # extrapolation one target per state; the fields they leave shared get
    # the batch axis too, as under vmap
    out = reweight(h, mu_star)
    if extrapolate:
        out = temp_dmu_extrap(out, meta, betas, dmus, order=order, skip_mom=not full_mom)
    dims = {"lnpi": 1, "mom": 6, "op": 1, "curr_mu": 1, "curr_beta": 0, "volume": 0}
    lead = {k: v.expand((T,) + v.shape) for k, v in ((k, getattr(out, k)) for k in dims) if v.dim() == dims[k]}
    return out.replace(**lead), mu_star, err, converged


def _trace(h: Hist, meta: HistMeta, betas, mu_guess, lnZ_tol: float, dmu, order: int, min_width: int, engine: str):
    """trace_coexistence's dict and the Nelder-Mead steps of each beta."""
    betas, dmus = _targets(h, _f64(h, betas).reshape(-1), dmu)
    T = betas.shape[0]
    obj = _Objective(h, meta, betas, dmus, order, min_width, True, None, engine, props_rows=True)
    mu0 = _f64(h, mu_guess).reshape(-1).expand(T).contiguous()
    mu_star, err, n_iter, converged = _solve(obj, mu0, lnZ_tol)
    # the properties at (mu*_t, beta_t) in one paired launch: K2 drops the
    # grand-canonical constant, to which fe and the (ratio) properties are
    # blind
    out = obj.segment(mu_star, torch.arange(T, dtype=torch.int32, device=h.device), props=True)
    keys = ("fe", "mask", "density", "x_i", "ntot", "u")
    return {"mu_star": mu_star, **{k: out[k] for k in keys}, "err": err, "converged": converged}, n_iter


@profiling.spanned("fhmc.entry.trace_coexistence")
def trace_coexistence(
    h: Hist,
    meta: HistMeta,
    betas,
    mu_guess,
    lnZ_tol: float = 1.0e-5,
    dmu=None,
    order: int = 1,
    min_width: int = 0,
    engine: str = "auto",
):
    """Vapor-liquid coexistence over a whole temperature array in one
    batched solve: the phase-diagram workflow of the reference notebooks
    (one serial scipy solve per beta).

    mu_guess is one guess for every beta (or one per beta); dmu, one dMu
    for every beta, defaults to the histogram's.  Returns a dict with
    per-beta mu_star, per-phase padded free energies, densities, x_i, ntot,
    u, masks, err and convergence flags (the JAX package's keys), each
    with a leading beta axis.  The properties come from one extrapolating
    sweep over the pairs (mu*_b, beta_b) at full moments, which is JAX's
    thermo_props of the extrapolated coexistence state.
    """
    return _trace(h, meta, betas, mu_guess, lnZ_tol, dmu, order, min_width, engine)[0]
