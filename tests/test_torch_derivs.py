"""PyTorch port: the derivative engines against the JAX package.

Every coefficient method of DerivEngine / DerivEngineN1 on the same
composite (n31: nspec 2, n573: nspec 1, max_order 3, used_ke off and on),
with and without the moment tensors.  Bar: 1e-12 absolute.  A field whose
entries exceed 1e2 is held to 1e-12 relative to max(1, its largest
entry): a grand-canonical average is one scalar, a sum over all bins
taken in another order than XLA's, and it enters every bin of the row, so
its rounding scales with the row's largest terms (measured worst 2.7e-16
of the largest entry, 2.3e-10 absolute on dB2 at N=1400, entries ~8.6e5).
The third-order beta row dB3 is held to 1e-11 absolute: it is built from
second-order GC fluctuation scalars (gc_d2X_dB2), each a chain of
<XY> - <X><Y> differences whose sums run over products of moment rows up
to ~1e5 (N^2 U, op^2 U), taken in another order than XLA's; measured
worst 2.2e-12 on entries of ~41 (n31).
"""

import numpy as np
import pytest
import torch

import fhmcanalysis_torch.core.derivs as TD
import fhmcanalysis_torch.core.state as TS
import fhmcanalysis_tpu.core.derivs as JD
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


def _engines(name, used_ke, n1=False, max_order=3):
    d, mk, _ = cell(name, 4, max_order=max_order, used_ke=used_ke)
    if n1:
        d = dict(d, op=np.array(d["mom"][0, 1, 0, 0, 0]))
    cls_t, cls_j = (TD.DerivEngineN1, JD.DerivEngineN1) if n1 else (TD.DerivEngine, JD.DerivEngine)
    return cls_t(TS.from_host(d, device="cpu"), TS.HistMeta(**mk)), cls_j(JS.make_hist(**d), JS.HistMeta(**mk))


def _pairs(got, want, what):
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{what}[{i}]")
    else:
        _same(got, want, what)


CASES = [("n31", False), ("n31", True), ("n573", False), ("n573", True)]


@pytest.mark.parametrize("skip_mom", [False, True])
@pytest.mark.parametrize("name,used_ke", CASES)
def test_coefficients_match_jax(name, used_ke, skip_mom):
    te, je = _engines(name, used_ke)
    methods = ["dB", "dB2", "dBMU", "dBMU2"] + (["dMU", "dMU2"] if te.meta.nspec > 1 else [])
    for meth in methods:
        _pairs(getattr(te, meth)(skip_mom), getattr(je, meth)(skip_mom), meth)
    if used_ke:
        for e in (te, je):
            with pytest.raises(ValueError, match="KE"):
                e.dB3(skip_mom)
    else:
        (g3, gm3), (w3, wm3) = te.dB3(skip_mom), je.dB3(skip_mom)
        _same(g3, w3, "dB3", tol=1e-11)
        _same(gm3, wm3, "dB3 moments")


@pytest.mark.parametrize("name,used_ke", CASES)
def test_building_blocks_match_jax(name, used_ke):
    """The gc_* scalars and sg_* rows the coefficients are built from,
    over the key addresses and their products."""
    te, je = _engines(name, used_ke)
    S = te.meta.nspec
    keys = [(i, 1, 0, 0, 0) for i in range(S)] + [(0, 0, 0, 0, 1)]
    for a in keys:
        _same(te.gc_ave_i(a), je.gc_ave_i(a), f"gc_ave_i{a}")
        _same(te.sg_d2X_dB2(a), je.sg_d2X_dB2(a), f"sg_d2X_dB2{a}")
        for n in (0, 1):
            _same(te.gc_dX_dB(a, n), je.gc_dX_dB(a, n), f"gc_dX_dB{a},{n}")
            _same(te.gc_d2X_dB2(a, n), je.gc_d2X_dB2(a, n), f"gc_d2X_dB2{a},{n}")
            _same(te.sg_dX_dB(a, n), je.sg_dX_dB(a, n), f"sg_dX_dB{a},{n}")
            _same(te.gc_df_dB_in((a, n), 1), je.gc_df_dB_in((a, n), 1), f"gc_df_dB_in{a},{n}")
        for b in keys:
            _same(te.gc_fluct_ii(a, b), je.gc_fluct_ii(a, b), f"gc_fluct_ii{a}{b}")
            _same(te.gc_df_dB_ii((a, 0), (b, 0)), je.gc_df_dB_ii((a, 0), (b, 0)), f"gc_df_dB_ii{a}{b}")
            _same(te.sg_df_dB((a, 0), (b, 0)), je.sg_df_dB((a, 0), (b, 0)), f"sg_df_dB{a}{b}")
        for q in range(S - 1):
            _same(te.sg_dX_dMU(q, a), je.sg_dX_dMU(q, a), f"sg_dX_dMU{q}{a}")
            _same(te.sg_d2X_dMU2(q, q, a), je.sg_d2X_dMU2(q, q, a), f"sg_d2X_dMU2{q}{a}")
            _same(te.sg_df_dMU(q, a, keys[0]), je.sg_df_dMU(q, a, keys[0]), f"sg_df_dMU{q}{a}")
    _same(te._mom_loop(1, lambda a: te.sg_dX_dB(a, 0)), je._mom_loop(1, lambda a: je.sg_dX_dB(a, 0)), "_mom_loop")
    u = (0, 0, 0, 0, 1)
    _same(te.sg_d2f_dB2(((0, 0, 0, 0, 0), 0), (u, 0)), je.sg_d2f_dB2(((0, 0, 0, 0, 0), 0), (u, 0)), "sg_d2f_dB2")


@pytest.mark.parametrize("skip_mom", [False, True])
def test_n1_engine_matches_jax(skip_mom):
    te, je = _engines("n31", False, n1=True)
    for meth in ("dB", "dB2", "dBMU", "dBMU2"):
        _pairs(getattr(te, meth)(skip_mom), getattr(je, meth)(skip_mom), f"n1 {meth}")
    for e in (te, je):
        with pytest.raises(NotImplementedError, match="N_1"):
            e.dB3(skip_mom)
        with pytest.raises(NotImplementedError, match="N_1"):
            e.sg_d3X_dB3((0, 1, 0, 0, 0))


@pytest.mark.parametrize("name", ["n31", "n573"])
def test_warm_sg_memo_matches_jax(name):
    d, mk, _ = cell(name, 4, max_order=3)
    for order in (1, 2):
        got = TD.warm_sg_memo(TS.from_host(d, device="cpu"), TS.HistMeta(**mk), order)
        want = JD.warm_sg_memo(JS.make_hist(**d), JS.HistMeta(**mk), order)
        assert got.keys() == want.keys()
        for k in want:
            _same(got[k], want[k], str(k))


def test_raises_where_jax_raises():
    """check_order: a derivative the moments are too short for."""
    te, je = _engines("n31", False, max_order=2)
    for e in (te, je):
        with pytest.raises(ValueError, match="max_order too low"):
            e.sg_dX_dB((0, 2, 0, 0, 0))
        with pytest.raises(ValueError, match="max_order too low"):
            e.sg_dX_dMU(0, (0, 0, 0, 0, 2))
