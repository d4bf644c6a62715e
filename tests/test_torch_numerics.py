"""PyTorch port: log-domain numerics and elementary ops against the JAX
package, at 1e-12 absolute on the same numpy inputs."""

import numpy as np
import pytest
import torch

import fhmcanalysis_torch.core.numerics as TN
import fhmcanalysis_torch.core.ops as TO
import fhmcanalysis_torch.core.state as TS
import fhmcanalysis_tpu.core.numerics as JN
import fhmcanalysis_tpu.core.ops as JO
import fhmcanalysis_tpu.core.state as JS
from torch_composites import CELLS, make_composite

torch.set_num_threads(1)
TOL = 1e-12


def _same(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    np.testing.assert_array_equal(got[~fin], want[~fin])  # same infinities
    assert np.max(np.abs(got[fin] - want[fin]), initial=0.0) <= tol


@pytest.mark.parametrize("axis", [0, -1])
@pytest.mark.parametrize("keepdims", [False, True])
def test_logsumexp_masked(axis, keepdims):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(6, 23)) * 200.0
    m = rng.random((6, 23)) < 0.6
    m[2] = False  # a fully masked row: -inf
    m[:, 5] = False  # a fully masked column
    x[4, :3] = -np.inf  # -inf entries inside a live row
    got = TN.logsumexp(torch.tensor(x), dim=axis, where=torch.tensor(m), keepdim=keepdims)
    want = JN.logsumexp(x, axis=axis, where=m, keepdims=keepdims)
    _same(got, want)
    _same(TN.logsumexp(torch.tensor(x), dim=axis, keepdim=keepdims), JN.logsumexp(x, axis=axis, keepdims=keepdims))


def test_normalize_and_reweight_lnpi():
    d = make_composite(**CELLS["n573"])
    t = {k: torch.tensor(v, dtype=torch.float64) for k, v in d.items()}
    _same(TN.normalize_lnpi(t["lnpi"]), JN.normalize_lnpi(d["lnpi"]))
    for mu in (-3.0, -0.5, 0.75):
        got = TN.reweight_lnpi(t["lnpi"], t["op"], t["curr_beta"], t["curr_mu"][0], torch.tensor(mu, dtype=torch.float64))
        _same(got, JN.reweight_lnpi(d["lnpi"], d["op"], d["curr_beta"], d["curr_mu"][0], mu))


def _hists(name):
    d = make_composite(**CELLS[name])
    return TS.from_host(d, device="cpu"), JS.make_hist(**d)


@pytest.mark.parametrize("name", ["n31", "n1400"])
@pytest.mark.parametrize("rigid_mu", [True, False])
def test_reweight_ops(name, rigid_mu):
    th, jh = _hists(name)
    for mu in (4.0, 5.3):
        got = TO.reweight(th, mu, rigid_mu=rigid_mu)
        want = JO.reweight(jh, mu, rigid_mu=rigid_mu)
        _same(got.lnpi, want.lnpi)
        _same(got.curr_mu, want.curr_mu)
        np.testing.assert_array_equal(got.mom.numpy(), np.asarray(want.mom))


def test_normalize_op():
    th, jh = _hists("n31")
    _same(TO.normalize(th).lnpi, JO.normalize(jh).lnpi)


def test_mix_equal_shape():
    d1 = make_composite(**CELLS["n31"])
    d2 = dict(d1, lnpi=d1["lnpi"][::-1].copy(), mom=d1["mom"] * 1.5)
    got = TO.mix_equal_shape(TS.from_host(d1, device="cpu"), TS.from_host(d2, device="cpu"), 0.3, 0.9)
    want = JO.mix_equal_shape(JS.make_hist(**d1), JS.make_hist(**d2), 0.3, 0.9)
    _same(got.lnpi, want.lnpi)
    # moments reach ~1e7 (N^4 rows); the mix is a per-element ratio, so
    # its rounding is relative: hold it at 1e-12 of each magnitude
    wm = np.asarray(want.mom)
    assert np.max(np.abs(got.mom.numpy() - wm) / np.maximum(1.0, np.abs(wm))) <= TOL
