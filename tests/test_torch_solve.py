"""PyTorch port: the coexistence solver (core.solve) against the JAX package.

Inputs are built in the repository: test_solve.py's LNPI laid over the
synthetic n31 composite (max_order 3, max_phases 8 as the class solver's
meta), and the coex573 cell (tests/torch_composites.py COEX573).  On the CPU
the port's objective runs the plain versions of K1 and K2's paired mode,
which segment lnPI as reweighted; JAX's normalises first.  Held here:

* segmentation (left, right, mask, n_phases, valid) equal to JAX's literal
  reweight -> temp_dmu_extrap -> thermo on every mu the solver evaluates;
* err^2 within 1e-12 absolute where err^2 <= 1, relative above; at order 2
  within 1e-10 on the same scale (the order-2 sweep's measured bar,
  tests/test_torch_mb.py:12-21);
* mu_star within 1e-9 (the JAX package's own bar between two trace
  engines, tests/test_solve.py:119), convergence flags and masks equal;
* the coexistence Hist's lnPI and moments, and the traced fe and phase
  properties, within 1e-12 relative to max(1, |value|).

Nelder-Mead on the quadratic returns JAX's x, f, n_iter and flag exactly
wherever each step's arithmetic is exact.  From JAX's own start, x0 = 0
(x1 = 0.00025, no binary fraction), x differs by 4 ulp while f, n_iter and
the flag stay equal: XLA on the CPU contracts 3a - 2b and 1.5a - 0.5b into
fused multiply-adds (229 and 239 of 1,000 random pairs round differently
from numpy and torch, which round each product).
"""

import numpy as np
import pytest
import torch

import fhmcanalysis_torch.core.cuda_mb as CM
import fhmcanalysis_torch.core.cuda_sweep as CS
import fhmcanalysis_torch.core.pipeline as TP
import fhmcanalysis_torch.core.segment as TSg
import fhmcanalysis_torch.core.solve as TSV
import fhmcanalysis_torch.core.state as TS
import fhmcanalysis_torch.utils.profiling as TPr
import fhmcanalysis_tpu.core.extrap as JE
import fhmcanalysis_tpu.core.ops as JO
import fhmcanalysis_tpu.core.segment as JSg
import fhmcanalysis_tpu.core.solve as JSV
import fhmcanalysis_tpu.core.state as JS
from torch_composites import cell, coex_grid, port_histogram

import jax
import jax.numpy as jnp

torch.set_num_threads(1)
SEG = ("left", "right", "mask", "n_phases", "valid")
PROPS = ("density", "x_i", "ntot", "u")
LNPI = np.array([0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 9, 8, 7, 6, 5, 4, 3, 2, 1, 0, 1, 2, 3, 4, 5, 4, 3, 2, 1, 0], dtype=np.float64)
BETAS = (0.99, 1.0, 1.01)  # test_solve.py's trace and vmapped solves
DMU = (-4.8,)  # an extrapolation target in dMu as well (the class shells' tests use it)


def _lnpi_state():
    d, mk, _ = cell("n31", 1, max_order=3)
    d, mk = dict(d, lnpi=LNPI), dict(mk, max_phases=8)
    return d, mk


@pytest.fixture(scope="module")
def state():
    """(port Hist, port meta, JAX Hist, JAX meta) of the LNPI state."""
    d, mk = _lnpi_state()
    return TS.from_host(d, device="cpu"), TS.HistMeta(**mk), JS.make_hist(**d), JS.HistMeta(**mk)


def _rel(got, want, ok=None) -> float:
    """max |got - want| / max(1, |want|), over ``ok`` where given."""
    g, w = np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64)
    if ok is not None:
        ok = np.asarray(ok).reshape(np.asarray(ok).shape + (1,) * (w.ndim - np.asarray(ok).ndim))
        g, w = np.where(ok, g, 0.0), np.where(ok, w, 0.0)
    with np.errstate(invalid="ignore"):
        d = np.where(g == w, 0.0, np.abs(g - w) / np.maximum(1.0, np.abs(w)))
    return float(d.max()) if d.size else 0.0


class _Recorder:
    """Every (objective, mu, tix, segmentation) the port's solver asks for."""

    def __init__(self, monkeypatch):
        self.calls = []
        segment = TSV._Objective.segment

        def rec(obj, mu, tix, props=False):
            out = segment(obj, mu, tix, props)
            self.calls.append((obj, mu.clone(), tix.clone(), {k: out[k].clone() for k in SEG}))
            return out

        monkeypatch.setattr(TSV._Objective, "segment", rec)


_JAX_SEG = {}


def _jax_segmentation(jh, jm, mus, betas, dmu, extrapolate, order):
    """JAX's literal reweight -> (temp_dmu_extrap, skip_mom) -> thermo
    segmentation at the points (mus[b], betas[b]), one jitted vmap per
    configuration."""
    key = (id(jh), extrapolate, order, tuple(np.asarray(dmu).ravel()))
    if key not in _JAX_SEG:
        dm = jnp.asarray(dmu, dtype=jnp.float64)

        def one(mu, beta):
            hh = JO.reweight(jh, mu)
            if extrapolate:
                hh = JE.temp_dmu_extrap(hh, jm, beta, dm, order=order, skip_mom=True)
            _, pt = JSg.thermo(hh, jm, props=False)
            return {k: getattr(pt, k) for k in SEG}

        _JAX_SEG[key] = jax.jit(jax.vmap(one))
    n = len(mus)
    pad = -n % 512  # a few padded shapes, so that the jitted vmap compiles once or twice
    mus, betas = np.pad(mus, (0, pad), mode="edge"), np.pad(betas, (0, pad), mode="edge")
    return {k: np.asarray(v)[:n] for k, v in _JAX_SEG[key](jnp.asarray(mus), jnp.asarray(betas)).items()}


def _check_trajectory(rec, jh, jm, betas, dmu, extrapolate, order):
    """Segmentation equal to JAX's on every point the solver evaluated."""
    assert rec.calls
    mus = np.concatenate([c[1].numpy() for c in rec.calls])
    tix = np.concatenate([c[2].numpy() for c in rec.calls])
    want = _jax_segmentation(jh, jm, mus, np.asarray(betas)[tix], dmu, extrapolate, order)
    for k in SEG:
        got = np.concatenate([c[3][k].numpy() for c in rec.calls])
        np.testing.assert_array_equal(got, want[k], err_msg=k)
    return len(mus)


def _err_bar(order):
    return 1e-12 if order == 1 else 1e-10


@pytest.mark.parametrize("extrapolate,order", [(False, 1), (False, 2), (True, 1), (True, 2)])
def test_phase_eq_error_matches_jax(state, monkeypatch, extrapolate, order):
    th, tm, jh, jm = state
    mus = np.array([4.8, 5.0, 5.2, 5.5])
    rec = _Recorder(monkeypatch)
    got = TSV.phase_eq_error(mus, th, tm, beta=1.01, dmu=DMU, order=order, min_width=2, extrapolate=extrapolate)
    assert got.shape == (4,)
    jerr = jax.jit(jax.vmap(lambda mu: JSV.phase_eq_error(mu, jh, jm, beta=1.01, dmu=jnp.asarray(DMU), order=order, min_width=2, extrapolate=extrapolate)))
    want = np.asarray(jerr(jnp.asarray(mus)))
    for i, mu in enumerate(mus):
        assert _rel(got[i], want[i]) <= _err_bar(order), (mu, float(got[i]), want[i])
        one = TSV.phase_eq_error(float(mu), th, tm, beta=1.01, dmu=DMU, order=order, min_width=2, extrapolate=extrapolate)
        assert one.dim() == 0 and float(one) == float(got[i])
    _check_trajectory(rec, jh, jm, [1.01], DMU, extrapolate, order)
    assert (got < TSV.DEFAULT_ERR2).any() and (got > 1.0).any()


def test_phase_eq_error_targets_per_point(state):
    """A batch of mu against a batch of targets pairs point b with target
    b, or with tix[b]; one target serves every point; counts that differ
    otherwise need tix."""
    th, tm, _, _ = state
    mus, betas = np.array([5.0, 5.2, 5.3]), np.array([0.99, 1.0, 1.01])
    kw = dict(dmu=DMU, min_width=2, extrapolate=True)
    paired = TSV.phase_eq_error(mus, th, tm, beta=betas, **kw)
    for b in range(3):
        assert float(paired[b]) == float(TSV.phase_eq_error(mus[b], th, tm, beta=betas[b], **kw))
    rev = TSV.phase_eq_error(mus, th, tm, beta=betas, tix=[2, 1, 0], **kw)
    assert float(rev[0]) == float(TSV.phase_eq_error(mus[0], th, tm, beta=betas[2], **kw))
    shared = TSV.phase_eq_error(mus, th, tm, beta=1.0, **kw)
    assert float(shared[2]) == float(TSV.phase_eq_error(mus[2], th, tm, beta=1.0, **kw))
    with pytest.raises(ValueError, match="pass tix"):
        TSV.phase_eq_error(np.append(mus, 5.4), th, tm, beta=betas, **kw)
    more = TSV.phase_eq_error(np.append(mus, 5.4), th, tm, beta=betas, tix=[0, 1, 2, 0], **kw)
    assert float(more[3]) == float(TSV.phase_eq_error(5.4, th, tm, beta=betas[0], **kw))


def _quad(c):
    return lambda x: (x - c) ** 2 + 1.0


@pytest.mark.parametrize("c", [2.5, 2.75, 3.0])
@pytest.mark.parametrize("x0", [20.0, 40.0, -20.0])
@pytest.mark.parametrize("xtol,ftol", [(1e-8, 1e-12), (1e-4, 1e-8)])
def test_nelder_mead_quadratic_matches_jax(c, x0, xtol, ftol):
    """Starts whose simplex stays on binary fractions: every step is exact
    in both packages, so the runs are the same run."""
    want = JSV.nelder_mead_1d(_quad(c), x0, xtol=xtol, ftol=ftol)
    got = TSV.nelder_mead_1d(_quad(c), x0, xtol=xtol, ftol=ftol)
    assert [float(want[0]), float(want[1]), int(want[2]), bool(want[3])] == [got[0].item(), got[1].item(), got[2].item(), got[3].item()]
    assert bool(got[3]) and got[0].dim() == 0


def test_nelder_mead_quadratic_from_zero():
    """test_solve.py's own case: x0 = 0, so x1 = 0.00025 (module docstring)."""
    want = JSV.nelder_mead_1d(_quad(2.5), 0.0, xtol=1e-8, ftol=1e-12)
    got = TSV.nelder_mead_1d(_quad(2.5), 0.0, xtol=1e-8, ftol=1e-12)
    assert (float(want[1]), int(want[2]), bool(want[3])) == (got[1].item(), got[2].item(), got[3].item())
    assert abs(float(want[0]) - got[0].item()) <= 4 * np.spacing(2.5)
    assert bool(got[3]) and abs(got[0].item() - 2.5) < 1e-6


def test_nelder_mead_batch_is_independent_runs(monkeypatch):
    """One batched run equals each target's own run bit for bit, whatever
    the sync interval: a finished target's state stays frozen; maxiter
    stops a target where JAX's loop would."""
    x0 = torch.tensor([0.0, 20.0, -3.0, 7.5])
    cs = torch.tensor([2.5, 2.75, -1.0, 3.0], dtype=torch.float64)

    def f(x):
        return (x - cs) ** 2 + 1.0

    runs = []
    for k in (1, 3, 8):
        monkeypatch.setattr(TSV, "SYNC_EVERY", k)
        runs.append(TSV.nelder_mead_1d(f, x0, xtol=1e-8, ftol=1e-12))
    for i in range(4):
        solo = TSV.nelder_mead_1d(_quad(float(cs[i])), float(x0[i]), xtol=1e-8, ftol=1e-12)
        for r in runs:
            assert [v[i].item() for v in r] == [v.item() for v in solo]
    capped = TSV.nelder_mead_1d(f, x0, xtol=1e-8, ftol=1e-12, maxiter=5)
    assert capped[2].tolist() == [5] * 4 and not capped[3].any()
    want = JSV.nelder_mead_1d(_quad(2.75), 20.0, xtol=1e-8, ftol=1e-12, maxiter=5)
    assert (float(want[0]), int(want[2])) == (capped[0][1].item(), capped[2][1].item())
    monkeypatch.setattr(TSV, "SYNC_EVERY", 0)
    with pytest.raises(ValueError, match="SYNC_EVERY"):
        TSV.nelder_mead_1d(f, x0)


def _check_hist(got, want):
    for k in ("lnpi", "mom", "op", "curr_mu", "curr_beta", "volume"):
        assert _rel(getattr(got, k).numpy(), np.asarray(getattr(want, k))) <= 1e-12, k


@pytest.mark.parametrize("extrapolate", [False, True])
def test_find_phase_eq_state_matches_jax(state, monkeypatch, extrapolate):
    th, tm, jh, jm = state
    beta = 1.01 if extrapolate else None
    want = JSV.find_phase_eq_state(jh, jm, 1e-6, 5.0, beta=beta, min_width=2, extrapolate=extrapolate)
    rec = _Recorder(monkeypatch)
    out, mu_star, err, conv = TSV.find_phase_eq_state(th, tm, 1e-6, 5.0, beta=beta, min_width=2, extrapolate=extrapolate)
    n = _check_trajectory(rec, jh, jm, [1.01], th.curr_mu[1:] - th.curr_mu[0], extrapolate, 1)
    assert n > 100
    assert mu_star.dim() == 0 and bool(conv) == bool(want[3]) and bool(conv)
    assert abs(float(mu_star) - float(want[1])) <= 1e-9
    assert _rel(float(err), float(want[2])) <= 1e-12
    _check_hist(out, want[0])
    # BASELINE.md: dFE/kT <= lnZ_tol at coexistence
    _, pt = TSg.thermo(out, tm, props=False)
    fe = pt.fe[pt.mask]
    assert len(fe) == 2 and abs(float(fe[0] - fe[1])) <= 1e-6


@pytest.fixture(scope="module")
def jax_trace(state):
    _, _, jh, jm = state
    return {k: np.asarray(v) for k, v in JSV.trace_coexistence(jh, jm, jnp.asarray(BETAS), 5.0, lnZ_tol=1e-6, min_width=2).items()}


def test_batched_solves(state, jax_trace):
    """The port's test_vmapped_solves: three betas in one find_phase_eq_state
    (the JAX package vmaps it): each equals its own solve bit for bit, and
    JAX's (inside trace_coexistence, the same solve) within 1e-9."""
    th, tm, _, _ = state
    dmu = th.curr_mu[1:] - th.curr_mu[0]
    out, mus, err, conv = TSV.find_phase_eq_state(th, tm, 1e-6, 5.0, beta=BETAS, dmu=dmu, order=1, min_width=2, extrapolate=True)
    assert mus.shape == (3,) and conv.all() and out.lnpi.shape == (3, th.nbins) and out.mom.shape == (3,) + th.mom.shape
    assert np.abs(mus.numpy() - jax_trace["mu_star"]).max() <= 1e-9
    for i, b in enumerate(BETAS):
        one, mu1, err1, _ = TSV.find_phase_eq_state(th, tm, 1e-6, 5.0, beta=b, dmu=dmu, order=1, min_width=2, extrapolate=True)
        assert (float(mus[i]), float(err[i])) == (float(mu1), float(err1))
        assert torch.equal(out.lnpi[i], one.lnpi) and torch.equal(out.mom[i], one.mom) and float(out.curr_beta[i]) == b
        _, pt = TSg.thermo(TS.Hist(**{k: getattr(out, k)[i] for k in ("lnpi", "mom", "op", "curr_mu", "curr_beta", "volume")}), tm, props=False)
        fe = pt.fe[pt.mask]
        assert len(fe) == 2 and abs(float(fe[0] - fe[1])) < 1e-4


def test_batched_solves_at_256(state):
    """test_batched_solves at the phase diagram's 256 betas: the states the
    batch builds in one pass equal each target's own solve bit for bit
    (every sum over the bins is its state's alone)."""
    th, tm, _, _ = state
    dmu = th.curr_mu[1:] - th.curr_mu[0]
    betas = np.linspace(0.99, 1.01, 256)
    out, mus, err, conv = TSV.find_phase_eq_state(th, tm, 1e-6, 5.0, beta=betas, dmu=dmu, order=1, min_width=2, extrapolate=True)
    assert conv.all() and out.lnpi.shape == (256, th.nbins)
    for i in (0, 97, 255):
        one, mu1, err1, _ = TSV.find_phase_eq_state(th, tm, 1e-6, 5.0, beta=betas[i], dmu=dmu, order=1, min_width=2, extrapolate=True)
        assert (float(mus[i]), float(err[i])) == (float(mu1), float(err1))
        assert torch.equal(out.lnpi[i], one.lnpi) and torch.equal(out.mom[i], one.mom) and torch.equal(out.curr_mu[i], one.curr_mu)


def _check_trace(got, want, mu_bar=1e-9):
    assert set(got) == set(want)
    for k in ("mask", "converged"):
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    assert np.abs(got["mu_star"].numpy() - want["mu_star"]).max() <= mu_bar
    assert np.abs(got["err"].numpy() - want["err"]).max() <= 1e-12
    for k in ("fe",) + PROPS:
        assert _rel(got[k].numpy(), want[k], want["mask"]) <= 1e-12, k


def _literal_props(jh, jm, mu_star, betas, dmu, order):
    """JAX's thermo_props of its extrapolated coexistence state (full
    moments), at the port's mu_star: trace_coexistence's last step."""
    dm = jnp.asarray(dmu, dtype=jnp.float64)

    def one(mu, b):
        hh = JE.temp_dmu_extrap(JO.reweight(jh, mu), jm, b, dm, order=order, skip_mom=False)
        _, pt, pp = JSg.thermo_props(hh, jm)
        return dict(fe=pt.fe, mask=pt.mask, **{k: pp[k] for k in PROPS})

    return {k: np.asarray(v) for k, v in jax.jit(jax.vmap(one))(jnp.asarray(mu_star), jnp.asarray(betas, dtype=jnp.float64)).items()}


def _check_props_literal(got, jh, jm, betas, dmu, order):
    want = _literal_props(jh, jm, got["mu_star"].numpy(), betas, dmu, order)
    np.testing.assert_array_equal(got["mask"].numpy(), want["mask"])
    for k in ("fe",) + PROPS:
        assert _rel(got[k].numpy(), want[k], want["mask"]) <= (1e-12 if order == 1 else 1e-10), k


def test_trace_coexistence_matches_jax(state, monkeypatch, jax_trace):
    th, tm, jh, jm = state
    rec = _Recorder(monkeypatch)
    got = TSV.trace_coexistence(th, tm, np.asarray(BETAS), 5.0, lnZ_tol=1e-6, min_width=2)
    _check_trace(got, jax_trace)
    dmu = (th.curr_mu[1:] - th.curr_mu[0]).numpy()
    _check_trajectory(rec, jh, jm, BETAS, dmu, True, 1)
    _check_props_literal(got, jh, jm, BETAS, dmu, 1)
    masks, fes, rhos = got["mask"], got["fe"], got["density"]
    for i in range(3):
        fe, rho = fes[i][masks[i]], rhos[i][masks[i]]
        assert len(fe) == 2 and abs(float(fe[0] - fe[1])) < 1e-6 and rho[0] != rho[1]
    d = np.diff(got["mu_star"].numpy())
    assert (d < 0).all() or (d > 0).all()


def test_trace_coexistence_order2_properties(state):
    """At order 2 the properties come from the order-2 key rows (full
    moments): JAX's thermo_props of the extrapolated state at the 1e-10
    bar of the order-2 sweep."""
    th, tm, jh, jm = state
    got = TSV.trace_coexistence(th, tm, np.asarray(BETAS), 5.0, lnZ_tol=1e-6, min_width=2, order=2)
    assert got["converged"].all() and (got["err"] <= 1e-12).all()
    _check_props_literal(got, jh, jm, BETAS, (th.curr_mu[1:] - th.curr_mu[0]).numpy(), 2)


def test_trace_coex573_matches_jax():
    """The coex573 cell at three of its 256 betas (both ends, the middle)."""
    d, mk, betas, guess, kw = coex_grid()
    betas = betas[[0, 128, 255]]
    th, tm, jh, jm = TS.from_host(d, device="cpu"), TS.HistMeta(**mk), JS.make_hist(**d), JS.HistMeta(**mk)
    want = {k: np.asarray(v) for k, v in JSV.trace_coexistence(jh, jm, jnp.asarray(betas), guess, **kw).items()}
    got = TSV.trace_coexistence(th, tm, betas, guess, **kw)
    assert want["converged"].all() and (want["err"] <= kw["lnZ_tol"] ** 2).all()
    _check_trace(got, want)


def test_device_solver_matches_class_solver(state):
    """The port's device solver against the port's class solver (scipy
    fmin over the class objective), as test_solve.py does for JAX."""
    th, tm, _, _ = state
    d, mk = _lnpi_state()
    h = port_histogram(d, mk, device="cpu")
    h.data["ln(PI)"] = LNPI.copy()
    _, mu_star, _, _ = TSV.find_phase_eq_state(th, tm, 1.0e-8, 5.0, min_width=2)
    eq = h.find_phase_eq(1.0e-8, 5.0)
    assert abs(float(mu_star) - eq.data["curr_mu"][0]) < 1e-3


def test_find_phase_eq_state_batch_of_guesses(state):
    """Without extrapolation a batch of mu guesses is a batch of solves
    (K1's objective on the card); each equals its own solve."""
    th, tm, _, _ = state
    guesses = [4.9, 5.0, 5.6]
    out, mus, err, conv = TSV.find_phase_eq_state(th, tm, 1e-6, guesses, min_width=2)
    assert conv.all() and out.lnpi.shape == (3, th.nbins)
    for i, g in enumerate(guesses):
        one, mu1, err1, conv1 = TSV.find_phase_eq_state(th, tm, 1e-6, g, min_width=2)
        assert (float(mus[i]), float(err[i]), bool(conv[i])) == (float(mu1), float(err1), bool(conv1))
        for k in ("lnpi", "mom", "op", "curr_mu", "curr_beta", "volume"):
            assert torch.equal(getattr(out, k)[i], getattr(one, k)), k
    assert np.ptp(mus.numpy()) <= 1e-9


CHUNK_CASES = [(name, order, props, collect) for name in ("n31", "n573") for order in (1, 2) for props in (True, False) for collect in (None, "janus")]


@pytest.mark.parametrize("name,order,props,collect", CHUNK_CASES)
def test_paired_chunk_equals_product_diagonal(name, order, props, collect):
    """The plain paired body (K2's paired mode) against the product body
    at the same (mu, target) points, bit for bit: the diagonal of an
    M = A product and random targets of an M x A one."""
    d, mk, mus = cell(name, 24, max_order=3)
    h, meta = TS.from_host(d, device="cpu"), TS.HistMeta(**mk)
    A = 24
    betas = np.linspace(0.95, 1.05, A)
    dmus = (d["curr_mu"][1:] - d["curr_mu"][0]) + np.linspace(-0.4, 0.4, A)[:, None] if mk["nspec"] == 2 else np.zeros((1, 0))
    mu, a, xrows, krows, tg = TP._mb_inputs(h, meta, mus, betas, dmus, order, props, False)
    prod = TP.mu_beta_sweep_body(h, meta, mus, betas, dmus, order, props, False, collect)
    for tix in (np.arange(A), np.random.default_rng(A).integers(0, A, size=A)):
        t = torch.as_tensor(tix, dtype=torch.int32)
        got = TP._mb_paired_body(h, meta, mu, a, xrows, krows, tg, t, order, props, collect)
        assert set(got) == set(prod)
        for k in got:
            assert torch.equal(got[k], prod[k][torch.arange(A), t.long()]), k
    n_ph = prod["n_phases"][prod["valid"]]
    assert (n_ph == 1).any() and (n_ph >= 2).any()


def test_paired_body_chunks_agree(monkeypatch):
    d, mk, mus = cell("n31", 10, max_order=3)
    h, meta = TS.from_host(d, device="cpu"), TS.HistMeta(**mk)
    mu, a, xrows, krows, tg = TP._mb_inputs(h, meta, mus, np.linspace(0.95, 1.05, 4), [[-5.0]], 2, True, False)
    tix = torch.as_tensor(np.arange(10) % 4, dtype=torch.int32)
    whole = TP._mb_paired_body(h, meta, mu, a, xrows, krows, tg, tix, 2, True)
    monkeypatch.setattr(TP, "_PLAIN_CHUNK_ELEMS", 3 * meta.max_phases * h.nbins)
    chunked = TP._mb_paired_body(h, meta, mu, a, xrows, krows, tg, tix, 2, True)
    for k in whole:
        assert torch.equal(whole[k], chunked[k]), k


def test_no_hidden_cpu_path(state):
    """engine='cuda' on CPU tensors raises before any launch; 'auto' and
    'torch' agree here; an unknown engine or collect raises."""
    th, tm, _, _ = state
    n1, n2 = CS.sweep_thermo.launches, CM.mb_sweep_thermo.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        TSV.phase_eq_error([5.0], th, tm, min_width=2, engine="cuda")
    with pytest.raises(ValueError, match="CUDA tensors"):
        TSV.phase_eq_error([5.0], th, tm, beta=1.01, min_width=2, extrapolate=True, engine="cuda")
    with pytest.raises(ValueError, match="CUDA tensors"):
        TSV.trace_coexistence(th, tm, BETAS, 5.0, min_width=2, engine="cuda")
    assert (CS.sweep_thermo.launches, CM.mb_sweep_thermo.launches) == (n1, n2) == (0, 0)
    a = TSV.trace_coexistence(th, tm, BETAS, 5.0, min_width=2, engine="auto")
    b = TSV.trace_coexistence(th, tm, BETAS, 5.0, min_width=2, engine="torch")
    for k in a:
        assert torch.equal(a[k], b[k]), k
    with pytest.raises(ValueError, match="engine"):
        TSV.find_phase_eq_state(th, tm, 1e-6, 5.0, engine="xla")
    with pytest.raises(KeyError):
        TSV.phase_eq_error(5.0, th, tm, collect="no-such-transform")
    with pytest.raises(ValueError, match="orders 1-2"):
        TSV.trace_coexistence(th, tm, BETAS, 5.0, order=3)


def test_profiling_helpers(tmp_path):
    """utils.profiling on the CPU: a trace written as trace.json with the
    block's operations in it, a Timer whose sections count, and
    force_completion a no-op."""
    x = torch.arange(1000, dtype=torch.float64)
    with TPr.trace(str(tmp_path / "prof")) as prof:
        y = (x * 2.0).sum()
    assert (tmp_path / "prof" / "trace.json").stat().st_size > 0
    assert any("mul" in e.name for e in prof.events())
    t = TPr.Timer()
    out = t.time("sum", lambda: {"y": (x + 1.0).sum(), "z": [x]})
    with t.section("mul", result=out):
        pass
    assert t.counts == {"sum": 1, "mul": 1} and float(out["y"]) == float(y) / 2.0 + 1000.0
    assert TPr.force_completion(out) is None
    assert t.report().splitlines()[0].split() == ["section", "total_s", "calls"]
