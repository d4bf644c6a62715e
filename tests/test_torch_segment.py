"""PyTorch port: segmentation and per-phase integration against the JAX
package on randomized lnPI structures.

Integer and bool fields must agree bit for bit; float fields to 1e-12
absolute, except the full moment averages (entries up to ~1e11: N^4 U^2
rows), held to 1e-12 relative to their magnitude.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import fhmcanalysis_torch.core.segment as TSg
import fhmcanalysis_torch.core.state as TS
import fhmcanalysis_tpu.core.segment as JSg
import fhmcanalysis_tpu.core.state as JS
from torch_composites import SURFACE_KINDS, janus_surfaces, make_composite, random_surface

torch.set_num_threads(1)
TOL = 1e-12
N = 64
P = 4


def _same(got, want, tol=TOL, rel=False):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    if got.dtype.kind in "biu":
        np.testing.assert_array_equal(got, want)
        return
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    np.testing.assert_array_equal(got[~fin], want[~fin])
    d = np.abs(got[fin] - want[fin])
    if rel:
        d = d / np.maximum(1.0, np.abs(want[fin]))
    assert np.max(d, initial=0.0) <= tol, np.max(d)


def _surfaces(kind, seed):
    """64 rows: 4 random surfaces of one kind, each under 16 mu tilts."""
    rng = np.random.default_rng(seed)
    op = np.arange(N, dtype=np.float64)
    rows = []
    for _ in range(4):
        y = random_surface(kind, N, rng)
        rows += [y + a * op for a in np.linspace(-0.15, 0.15, 16)]
    return np.stack(rows)


def _composite(nspec):
    d = make_composite(N=N, nspec=nspec, beta=1.0, mu0=(0.0,) * nspec, seed=7)
    return d, TS.HistMeta(nspec=nspec, max_order=2, max_phases=P), JS.HistMeta(nspec=nspec, max_order=2, max_phases=P)


def _ext_same(te, je):
    for f in ("maxima", "n_max", "minima", "n_min", "valid"):
        _same(getattr(te, f), getattr(je, f))


def _pt_same(tp, jp):
    for f in ("left", "right", "mask", "n_phases", "valid", "fe"):
        _same(getattr(tp, f), getattr(jp, f))
    _same(tp.mom_avg, jp.mom_avg, rel=True)


@pytest.mark.parametrize("smooth", [1, 2])
@pytest.mark.parametrize("kind", SURFACE_KINDS)
def test_segmentation_randomized(kind, smooth):
    x = _surfaces(kind, seed=100 * smooth + SURFACE_KINDS.index(kind))
    xt = torch.tensor(x)
    te = TSg.relextrema(xt, smooth, P)
    je = jax.vmap(lambda r: JSg.relextrema(r, smooth, P))(x)
    _ext_same(te, je)
    _ext_same(TSg.janus_collect_extrema(te, P), jax.vmap(lambda e: JSg.janus_collect_extrema(e, P))(je))
    tb = TSg.phase_bounds(te, N, P)
    jb = jax.vmap(lambda e: JSg.phase_bounds(e, N, P))(je)
    for a, b in zip(tb, jb):
        _same(a, b)


@pytest.mark.parametrize("smooth", [1, 2])
@pytest.mark.parametrize("kind", SURFACE_KINDS)
def test_thermo_cores_randomized(kind, smooth):
    x = _surfaces(kind, seed=7 + 100 * smooth + SURFACE_KINDS.index(kind))
    d, tm, jm = _composite(2)
    tm, jm = dataclasses.replace(tm, smooth=smooth), dataclasses.replace(jm, smooth=smooth)
    xt, mt = torch.tensor(x), torch.tensor(d["mom"])
    _pt_same(TSg.thermo_core(xt, mt, tm), jax.vmap(lambda r: JSg.thermo_core(r, d["mom"], jm))(x))
    key_t = TSg.key_rows(mt, tm)
    key_j = d["mom"].reshape(jm.n_addr, N)[JSg.key_row_addresses(jm)]
    tp, tprops = TSg.thermo_key_core(xt, key_t, tm, torch.tensor(d["volume"]))
    jp, jprops = jax.vmap(lambda r: JSg.thermo_key_core(r, key_j, jm, d["volume"]))(x)
    _pt_same(tp, jp)
    assert tprops.keys() == jprops.keys()
    for k in tprops:
        _same(tprops[k], jprops[k])


@pytest.mark.parametrize("dedupe_mom", [True, False])
@pytest.mark.parametrize("nspec", [1, 2])
def test_thermo_core_full_moments(nspec, dedupe_mom):
    x = _surfaces("multi_well", seed=11 + nspec)
    d, tm, jm = _composite(nspec)
    got = TSg.thermo_core(torch.tensor(x), torch.tensor(d["mom"]), tm, dedupe_mom=dedupe_mom)
    want = jax.vmap(lambda r: JSg.thermo_core(r, d["mom"], jm, dedupe_mom=dedupe_mom))(x)
    _pt_same(got, want)
    tprops = TSg.phase_props(got, d["volume"])
    jprops = jax.vmap(lambda pt: JSg.phase_props(pt, d["volume"]))(want)
    for k in ("ntot", "x_i", "density"):
        _same(tprops[k], jprops[k], rel=True)


@pytest.mark.parametrize("surface", range(4))
def test_janus_collect_multipeak(surface):
    d, tm, jm = _composite(2)
    y = janus_surfaces(N)[surface]
    x = np.stack([y + a * np.arange(N) for a in np.linspace(-0.05, 0.05, 8)])
    tp, tprops = TSg.thermo_core_props(torch.tensor(x), torch.tensor(d["mom"]), tm, torch.tensor(d["volume"]), collect="janus")
    jp, jprops = jax.vmap(lambda r: JSg.thermo_core_props(r, d["mom"], jm, d["volume"], collect="janus"))(x)
    _pt_same(tp, jp)
    for k in tprops:
        _same(tprops[k], jprops[k])


@pytest.mark.parametrize("complete", [False, True])
def test_hist_level_thermo(complete):
    d, tm, jm = _composite(2)
    d = dict(d, lnpi=janus_surfaces(N)[3] * 20.0)
    th, jh = TS.from_host(d, device="cpu"), JS.make_hist(**d)
    (th2, tp), (jh2, jp) = TSg.thermo(th, tm, complete=complete), JSg.thermo(jh, jm, complete=complete)
    _same(th2.lnpi, jh2.lnpi)
    _pt_same(tp, jp)
    _, tp, tprops = TSg.thermo_props(th, tm, complete=complete)
    _, jp, jprops = JSg.thermo_props(jh, jm, complete=complete)
    _pt_same(tp, jp)
    for k in tprops:
        _same(tprops[k], jprops[k])
    for cutoff in (1.0, 10.0, 1e3):
        assert bool(TSg.is_safe(th, tm, cutoff, complete)) == bool(JSg.is_safe(jh, jm, cutoff, complete))


def test_stencil_rejects_smooth_zero():
    with pytest.raises(ValueError, match="smooth must be >= 1"):
        TSg.stencil_flags(torch.zeros(2, 8, dtype=torch.float64), 0)


def _batched_states(nspec, T=6):
    """T states, each with its own lnPI and moments: JAX's reweight ->
    temp_dmu_extrap (full moments) of the composite under vmap, over mu_1
    values across its two-phase window and T betas."""
    import jax.numpy as jnp

    import fhmcanalysis_tpu.core.extrap as JE
    import fhmcanalysis_tpu.core.ops as JO

    d, _, _ = _composite(nspec)
    d = dict(d, lnpi=janus_surfaces(N)[3] * 20.0)
    tm, jm = TS.HistMeta(nspec=nspec, max_order=2, smooth=2, max_phases=P), JS.HistMeta(nspec=nspec, max_order=2, smooth=2, max_phases=P)
    mus = np.linspace(-0.05, 0.05, T)
    betas = np.linspace(0.98, 1.02, T)
    dmu = jnp.zeros(nspec - 1)
    states = jax.vmap(lambda mu, b: JE.temp_dmu_extrap(JO.reweight(JS.make_hist(**d), mu), jm, b, dmu, order=1))(mus, betas)
    host = {f: np.asarray(getattr(states, f)) for f in ("lnpi", "mom", "op", "curr_mu", "curr_beta", "volume")}
    return TS.Hist(**{k: torch.tensor(v) for k, v in host.items()}), tm, states, jm


@pytest.mark.parametrize("nspec", [1, 2])
def test_batched_thermo(nspec):
    """thermo, phase_props and thermo_props of T states, each segmented and
    integrated with its own moments, against JAX's under vmap; each row
    against the one-state call."""
    th, tm, jh, jm = _batched_states(nspec)
    th2, tp = TSg.thermo(th, tm)
    jh2, jp = jax.vmap(lambda h: JSg.thermo(h, jm))(jh)
    _same(th2.lnpi, jh2.lnpi)
    _pt_same(tp, jp)
    assert bool(tp.valid.all()) and int(tp.n_phases.min()) >= 2
    tprops = TSg.phase_props(tp, th.volume)
    jprops = jax.vmap(JSg.phase_props)(jp, jh.volume)
    for k in tprops:
        _same(tprops[k], jprops[k], rel=True)
    _, kp, kprops = TSg.thermo_props(th, tm)
    _, jkp, jkprops = jax.vmap(lambda h: JSg.thermo_props(h, jm))(jh)
    _pt_same(kp, jkp)
    for k in kprops:
        _same(kprops[k], jkprops[k], rel=True)
    for t in range(th.lnpi.shape[0]):
        one = TS.Hist(**{f.name: getattr(th, f.name)[t] for f in dataclasses.fields(th)})
        _, op = TSg.thermo(one, tm)
        for f in ("left", "right", "mask", "n_phases", "valid", "fe"):
            assert torch.equal(getattr(tp, f)[t], getattr(op, f)), (t, f)
        _same(tp.mom_avg[t], op.mom_avg, rel=True)
