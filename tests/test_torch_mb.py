"""PyTorch port: the (mu_1, beta, dMu) extrapolating sweep against the JAX
package.

The port's mu_beta_sweep_thermo on CPU runs the plain version
(pipeline.mu_beta_sweep_body), which builds lnPI' without the per-point
grand-canonical averages (a constant over the bins the thermo tail
cancels; pipeline.py says why).  It is held against JAX
mu_beta_sweep_thermo(engine="xla") with segmentation (valid, mask,
n_phases, left, right) bit for bit, and floats to 1e-12 -- absolute, or
relative to max(1, |value|) for a field whose entries exceed 1e2.

Order 2 is held to 1e-10 on the same scale.  Its lnPI' adds
0.5 dB^2 h00 with h00 up to 8.6e5 (N=1400), terms of ~3e3 whose rounding
differs between the two packages' association by ~1e-12 per bin; a phase
average <N_i> over a distribution some 300 bins wide amplifies that by the
width.  Measured worst at N=1400: 2.0e-11 relative on N_tot and 1.7e-11
on <N_i> (1.6e-8 absolute), 9.3e-12 on the density, 3.8e-12 on x_i,
7e-14 relative on fe; order 1 stays under 1.3e-13.  The port's own literal composition
(reweight -> temp_dmu_extrap_key -> thermo, averages included) is as far
from JAX, and within 1e-12 of the GC-free body
(test_gc_free_body_matches_literal_composition).
"""

import numpy as np
import pytest
import torch

import fhmcanalysis_torch.core.cuda_mb as CM
import fhmcanalysis_torch.core.extrap as TE
import fhmcanalysis_torch.core.ops as TO
import fhmcanalysis_torch.core.pipeline as TP
import fhmcanalysis_torch.core.segment as TSg
import fhmcanalysis_torch.core.state as TS
from fhmcanalysis_torch.utils.profiling import counters
import fhmcanalysis_tpu.core.pipeline as JP
import fhmcanalysis_tpu.core.state as JS
from fhmcanalysis_tpu.core.pallas_mb import mu_beta_sweep_thermo_ds
from torch_composites import cell, mb_grid

torch.set_num_threads(1)
SEG = ("valid", "mask", "n_phases", "left", "right")
PROPS = ("n_i", "x_i", "ntot", "u", "density")


def _inputs(name, M, A=3, used_ke=False):
    d, mk, mus = cell(name, M, max_order=3, used_ke=used_ke)
    betas = np.linspace(0.92, 1.08, A)
    dref = d["curr_mu"][1:] - d["curr_mu"][0]
    dmus = dref + np.linspace(-0.5, 0.5, A)[:, None] if mk["nspec"] == 2 else np.zeros((1, 0))
    return TS.from_host(d, device="cpu"), TS.HistMeta(**mk), JS.make_hist(**d), JS.HistMeta(**mk), mus, betas, dmus


def _worst(got, want, ok):
    g, w = np.asarray(got), np.asarray(want)
    okx = ok.reshape(ok.shape + (1,) * (w.ndim - ok.ndim))
    g, w = np.where(okx, g, 0.0), np.where(okx, w, 0.0)
    with np.errstate(invalid="ignore"):  # fe is +inf on a masked phase with no mass
        d = np.where(g == w, 0.0, np.abs(g - w))
    if np.max(np.abs(w), initial=0.0) > 1e2:
        d = d / np.maximum(1.0, np.abs(w))
    return float(d.max()) if d.size else 0.0


def _check(got, want, props, tol):
    assert set(got) == set(want)
    for k in SEG:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)
    ok = np.asarray(want["mask"])
    for k in ("fe",) + (PROPS if props else ()):
        assert np.asarray(got[k]).shape == np.asarray(want[k]).shape, k
        assert _worst(got[k], want[k], ok) <= tol, (k, _worst(got[k], want[k], ok))


def _both_phases(out):
    n_ph = np.asarray(out["n_phases"])
    assert np.asarray(out["valid"]).all() and (n_ph == 1).any() and (n_ph >= 2).any()


CASES = [
    (name, order, props, collect, used_ke)
    for name in ("n31", "n573", "n1400")
    for order in (1, 2)
    for props in (True, False)
    for collect in ((None, "janus") if name != "n573" and props else (None,))
    for used_ke in (False,)
] + [("n31", 1, True, None, True), ("n31", 2, True, None, True)]


@pytest.mark.parametrize("name,order,props,collect,used_ke", CASES)
def test_mb_matches_jax_xla(name, order, props, collect, used_ke):
    th, tm, jh, jm, mus, betas, dmus = _inputs(name, 12, used_ke=used_ke)
    got = TP.mu_beta_sweep_thermo(th, tm, mus, betas, dmus, order=order, props=props, collect=collect)
    want = JP.mu_beta_sweep_thermo(jh, jm, mus, betas, dmus, order=order, props=props, collect=collect, engine="xla")
    _check(got, want, props, 1e-12 if order == 1 else 1e-10)
    _both_phases(got)


def _literal(th, tm, mus, betas, dmus, order, first_order_mom):
    """The port's own reweight -> temp_dmu_extrap_key -> thermo_key_core,
    one point at a time, grand-canonical averages included."""
    rows = []
    for mu in mus:
        hh = TO.reweight(th, float(mu))
        for bt, dm in zip(betas, np.broadcast_to(dmus, (len(betas), dmus.shape[1]))):
            lnpi, key = TE.temp_dmu_extrap_key(hh, tm, bt, dm, order=order, first_order_mom=first_order_mom)
            pt, pp = TSg.thermo_key_core(lnpi[None], key, tm, hh.volume)
            rows.append(dict(fe=pt.fe, mask=pt.mask, left=pt.left, right=pt.right, n_phases=pt.n_phases, valid=pt.valid, **pp))
    return {k: torch.cat([r[k] for r in rows]).reshape((len(mus), len(betas)) + rows[0][k].shape[1:]) for k in rows[0]}


@pytest.mark.parametrize("order,first_order_mom", [(1, False), (2, False), (2, True)])
@pytest.mark.parametrize("name", ["n31", "n573", "n1400"])
def test_gc_free_body_matches_literal_composition(name, order, first_order_mom):
    """Dropping the grand-canonical averages changes no output: the plain
    body against the literal composition, to 1e-12."""
    th, tm, _, _, mus, betas, dmus = _inputs(name, 4)
    got = TP.mu_beta_sweep_body(th, tm, mus, betas, dmus, order=order, first_order_mom=first_order_mom)
    _check(got, _literal(th, tm, mus, betas, dmus, order, first_order_mom), True, 1e-12)


@pytest.mark.parametrize("order,collect", [(1, None), (2, "janus")])
def test_mb_matches_k2_cpu_body(order, collect):
    """K2's own CPU body (the double-single lanes path, as the JAX package
    tests it) at that kernel's 1e-9 bar."""
    th, tm, jh, jm, mus, betas, dmus = _inputs("n31", 6)
    got = TP.mu_beta_sweep_thermo(th, tm, mus, betas, dmus, order=order, collect=collect)
    want = mu_beta_sweep_thermo_ds(jh, jm, mus, betas, dmus, order=order, mode="xla", collect=collect)
    _check(got, want, True, 1e-9)


@pytest.mark.parametrize("props", [True, False])
@pytest.mark.parametrize("name", ["n31", "n573"])
def test_identity_targets_equal_the_mu_sweep(name, props):
    """At beta = beta_ref, dMu = dMu_ref every added term is an exact zero:
    the result is the mu sweep's, segmentation bit for bit."""
    th, tm, _, _, mus, _, _ = _inputs(name, 24)
    dmus = (th.curr_mu[1:] - th.curr_mu[0]).numpy()[None]
    for order in (1, 2):
        got = TP.mu_beta_sweep_thermo(th, tm, mus, th.curr_beta.reshape(1).numpy(), dmus, order=order, props=props)
        want = TP.mu_sweep_thermo(th, tm, mus, props=props)
        _check({k: v[:, 0] for k, v in got.items()}, want, props, 1e-12)


def test_mb_grid_crosses_coexistence():
    """The main-path grid (mb31, cut to a few points) holds one- and
    two-phase points at both orders."""
    d, mk, mus, betas, dmus = mb_grid(M=64, A=8)
    th, tm = TS.from_host(d, device="cpu"), TS.HistMeta(**mk)
    for order in (1, 2):
        out = TP.mu_beta_sweep_thermo(th, tm, mus, betas, dmus, order=order)
        assert out["fe"].shape == (64, 8, tm.max_phases)
        n_ph = out["n_phases"][out["valid"]]
        assert (n_ph == 1).any() and (n_ph == 2).any()


def test_plain_chunks_agree(monkeypatch):
    """Chunking over mu changes nothing: every point is independent."""
    th, tm, _, _, mus, betas, dmus = _inputs("n31", 10)
    whole = TP.mu_beta_sweep_thermo(th, tm, mus, betas, dmus, order=2)
    monkeypatch.setattr(TP, "_PLAIN_CHUNK_ELEMS", 3 * len(betas) * tm.max_phases * th.nbins)
    chunked = TP.mu_beta_sweep_thermo(th, tm, mus, betas, dmus, order=2)
    for k in whole:
        assert torch.equal(whole[k], chunked[k]), k


def test_no_hidden_cpu_path():
    """A CPU tensor never reaches K2: engine='cuda' raises, the launch
    counter stays put, and engine='torch' equals 'auto' here."""
    th, tm, _, _, mus, betas, dmus = _inputs("n31", 4)
    before = counters().get("launches.k2", 0)
    with pytest.raises(ValueError, match="CUDA tensors"):
        TP.mu_beta_sweep_thermo(th, tm, mus, betas, dmus, engine="cuda")
    a = TP.mu_beta_sweep_thermo(th, tm, mus, betas, dmus, engine="auto")
    b = TP.mu_beta_sweep_thermo(th, tm, mus, betas, dmus, engine="torch")
    assert counters().get("launches.k2", 0) == before == 0
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_rejects_what_it_does_not_cover():
    th, tm, _, _, mus, betas, dmus = _inputs("n31", 4)
    with pytest.raises(ValueError, match="orders 1-2"):
        TP.mu_beta_sweep_thermo(th, tm, mus, betas, dmus, order=3)
    with pytest.raises(ValueError, match="dmu_grid"):
        TP.mu_beta_sweep_thermo(th, tm, mus, betas, np.zeros((len(betas), 2)))
    with pytest.raises(KeyError):
        TP.mu_beta_sweep_thermo(th, tm, mus, betas, dmus, collect="no-such-transform")
    with pytest.raises(ValueError, match="engine"):
        TP.mu_beta_sweep_thermo(th, tm, mus, betas, dmus, engine="xla")
