"""PyTorch port: the Taylor extrapolation drivers against the JAX package.

Each driver of core/extrap.py on the same composite (n31: nspec 2, n573:
nspec 1, max_order 3), orders 1-2 (1-3 for temp_extrap), with and
without first_order_mom: lnPI, the key rows, the moments and the new
state.  Bar: 1e-12 absolute; a field whose entries exceed 1e2 (the
moments reach ~1e12, N^6 U^3 rows) is held relative to its largest entry,
as in test_torch_derivs.py.  Order-3 lnPI is held to 1e-11: its dB3 row
carries the 2.2e-12 of test_torch_derivs.py.
"""

import numpy as np
import pytest
import torch

import fhmcanalysis_torch.core.extrap as TE
import fhmcanalysis_torch.core.state as TS
import fhmcanalysis_tpu.core.extrap as JE
import fhmcanalysis_tpu.core.state as JS
from torch_composites import cell

torch.set_num_threads(1)
TOL = 1e-12


def _same(got, want, what="", tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    big = np.max(np.abs(want), initial=0.0)
    d = np.max(np.abs(got - want), initial=0.0)
    if big > 1e2:
        d = d / big
    assert d <= tol, (what, d)


def _hist_same(got, want, tol=TOL):
    for f in ("lnpi", "mom", "op", "curr_mu", "curr_beta", "volume"):
        _same(getattr(got, f), getattr(want, f), f, tol if f == "lnpi" else TOL)


def _inputs(name, n1=False):
    d, mk, _ = cell(name, 4, max_order=3)
    if n1:
        d = dict(d, op=np.array(d["mom"][0, 1, 0, 0, 0]))
    return TS.from_host(d, device="cpu"), TS.HistMeta(**mk), JS.make_hist(**d), JS.HistMeta(**mk)


@pytest.mark.parametrize("skip_mom", [False, True])
@pytest.mark.parametrize("order", [1, 2, 3])
@pytest.mark.parametrize("name", ["n31", "n573"])
def test_temp_extrap(name, order, skip_mom):
    th, tm, jh, jm = _inputs(name)
    got = TE.temp_extrap(th, tm, 1.06, order=order, skip_mom=skip_mom)
    _hist_same(got, JE.temp_extrap(jh, jm, 1.06, order=order, skip_mom=skip_mom), tol=1e-11 if order == 3 else TOL)


@pytest.mark.parametrize("order", [1, 2])
def test_dmu_extrap(order):
    th, tm, jh, jm = _inputs("n31")
    _hist_same(TE.dmu_extrap(th, tm, [-4.6], order=order), JE.dmu_extrap(jh, jm, np.array([-4.6]), order=order))


@pytest.mark.parametrize("first_order_mom", [False, True])
@pytest.mark.parametrize("order", [1, 2])
@pytest.mark.parametrize("name", ["n31", "n573"])
def test_temp_dmu_extrap_and_key(name, order, first_order_mom):
    th, tm, jh, jm = _inputs(name)
    dmu = [-5.3] if tm.nspec == 2 else []
    kw = dict(order=order, first_order_mom=first_order_mom)
    _hist_same(TE.temp_dmu_extrap(th, tm, 0.95, dmu, **kw), JE.temp_dmu_extrap(jh, jm, 0.95, np.array(dmu), **kw))
    (gl, gk), (wl, wk) = TE.temp_dmu_extrap_key(th, tm, 0.95, dmu, **kw), JE.temp_dmu_extrap_key(jh, jm, 0.95, np.array(dmu), **kw)
    _same(gl, wl, "key lnpi")
    _same(gk, wk, "key rows")


@pytest.mark.parametrize("first_order_mom", [False, True])
@pytest.mark.parametrize("order", [1, 2])
def test_temp_dmu_extrap_grid(order, first_order_mom):
    th, tm, jh, jm = _inputs("n31")
    betas, dmus = np.array([0.93, 1.0, 1.07]), np.array([[-5.4], [-4.7]])
    kw = dict(order=order, first_order_mom=first_order_mom)
    _hist_same(TE.temp_dmu_extrap_grid(th, tm, betas, dmus, **kw), JE.temp_dmu_extrap_grid(jh, jm, betas, dmus, **kw))


@pytest.mark.parametrize("order", [1, 2])
def test_temp_mu_extrap_n1(order):
    th, tm, jh, jm = _inputs("n31", n1=True)
    _hist_same(TE.temp_mu_extrap(th, tm, 1.04, [0.3], order=order), JE.temp_mu_extrap(jh, jm, 1.04, np.array([0.3]), order=order))
    betas, mus = np.array([0.96, 1.04]), np.array([[0.3], [-0.2], [0.1]])
    _hist_same(TE.temp_mu_extrap_grid(th, tm, betas, mus, order=order), JE.temp_mu_extrap_grid(jh, jm, betas, mus, order=order))


def test_orders_out_of_range_raise():
    th, tm, jh, jm = _inputs("n31")
    for E, h, m in ((TE, th, tm), (JE, jh, jm)):
        with pytest.raises(ValueError, match="order 4"):
            E.temp_extrap(h, m, 1.05, order=4)
        with pytest.raises(ValueError, match="order 3"):
            E.temp_dmu_extrap(h, m, 1.05, np.array([-5.2]), order=3)
        with pytest.raises(ValueError, match="order 3"):
            E.dmu_extrap(h, m, np.array([-5.2]), order=3)
    ke = TS.HistMeta(**dict(tm.__dict__, used_ke=True))
    with pytest.raises(ValueError, match="KE"):
        TE.temp_extrap(th, ke, 1.05, order=3)
