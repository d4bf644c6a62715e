"""PyTorch port: the host class shells (histogram.ntot, histogram.n1, io,
histogram.collect) against the JAX package.

Each composite is written to a .nc file with the port's write_composite
and loaded by both packages' classes (the port's with device="cpu"), so
both see identical inputs.  Floats agree to 1e-12 absolute, or relative to
max(1, |value|) where a value exceeds 1 (moments and their derivatives
run to ~1e5 here); integers, index lists and strings are equal.
"""

import numpy as np
import pytest
import torch

import fhmcanalysis_torch.histogram.n1 as TN1
import fhmcanalysis_torch.histogram.ntot as TNT
import fhmcanalysis_torch.io as TIO
import fhmcanalysis_tpu.histogram.n1 as JN1
import fhmcanalysis_tpu.histogram.ntot as JNT
import fhmcanalysis_tpu.io as JIO
from fhmcanalysis_torch.histogram.collect import janus_collect
from fhmcanalysis_tpu.histogram.collect import janus_collect as jax_janus_collect
from torch_composites import cell, composite_raw, port_histogram

torch.set_num_threads(1)
BAR = 1e-12
MU2P = 10.0  # a mu_1 in the n31 window where lnPI has two phases
HISTORY = "synthetic composite"


def same(a, b, bar=BAR, where="value"):
    """a (port) equals b (JAX) within bar, relative to max(1, |b|)."""
    if isinstance(b, dict):
        assert set(a) == set(b), (where, set(a) ^ set(b))
        for k in b:
            same(a[k], b[k], bar, f"{where}[{k!r}]")
    elif isinstance(b, (list, tuple)) and not np.isscalar(b):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            same(x, y, bar, f"{where}[{i}]")
    elif isinstance(b, str) or b is None:
        assert a == b, where
    else:
        x, y = np.asarray(a), np.asarray(b)
        assert x.shape == y.shape, (where, x.shape, y.shape)
        if y.dtype.kind in "biu" or x.dtype.kind in "biu":
            np.testing.assert_array_equal(x, y, err_msg=where)
        else:
            with np.errstate(invalid="ignore"):
                d = np.where(x == y, 0.0, np.abs(x - y) / np.maximum(1.0, np.abs(y)))
            assert float(np.max(d, initial=0.0)) <= bar, (where, float(np.max(d)))


@pytest.fixture(scope="module")
def nc31(tmp_path_factory):
    """The n31 composite (nspec 2) at max_order 4, so order-3 temperature
    extrapolation of the moments is representable: (path, dict, meta)."""
    d, mk, _ = cell("n31", 1, max_order=4)
    p = str(tmp_path_factory.mktemp("h") / "n31.nc")
    TIO.write_composite(p, d["lnpi"], d["op"], d["mom"], d["volume"], 2, 4, history=HISTORY)
    return p, d, mk


def pair(nc31, cls=(TNT.histogram, JNT.histogram), smooth=1):
    p, d, _ = nc31
    return cls[0](p, d["curr_beta"], d["curr_mu"], smooth, device="cpu"), cls[1](p, d["curr_beta"], d["curr_mu"], smooth)


def _thermo_data(h):
    return {k: h.data[k] for k in h.data if k not in ("pk_hist", "e_hist")}


# ---------------------------------------------------------------------------
# io


def test_io_round_trips(tmp_path):
    d, mk, _ = cell("n31", 1, max_order=3)
    pk = {"hist": np.full((2, 31, 4), 0.25), "lb": np.zeros((2, 31)), "ub": np.full((2, 31), 3.0), "bw": np.ones((2, 31))}
    eh = {"hist": np.full((31, 4), 0.25), "lb": np.zeros(31), "ub": np.full(31, 3.0), "bw": np.ones(31)}
    args = (d["lnpi"], d["op"], d["mom"], d["volume"], 2, 3)
    TIO.write_composite(str(tmp_path / "port.nc"), *args, pk_hist=pk, e_hist=eh, history=HISTORY)
    JIO.write_composite(str(tmp_path / "jax.nc"), *args, pk_hist=pk, e_hist=eh, history=HISTORY)
    for fn in ("port.nc", "jax.nc"):
        a = TIO.read_composite(str(tmp_path / fn))
        b = JIO.read_composite(str(tmp_path / fn))
        same(a, b, 0.0)
        assert a["history"] == HISTORY and a["nspec"] == 2 and a["max_order"] == 3
        np.testing.assert_array_equal(a["mom"], d["mom"])
    same(TIO.read_composite(str(tmp_path / "port.nc")), JIO.read_composite(str(tmp_path / "jax.nc")), 0.0)
    with TIO.NCFile(str(tmp_path / "jax.nc")) as f:
        assert f.history == HISTORY and int(f.nspec) == 2 and "ln(PI)" in f.variables


def test_helper_built_histogram_equals_file_loaded(nc31):
    """torch_composites.port_histogram (no file; the class's own _take
    path) gives the file-loaded histogram field for field."""
    p, d, mk = nc31
    a = TNT.histogram(p, d["curr_beta"], d["curr_mu"], mk["smooth"], device="cpu")
    b = port_histogram(d, mk, device="cpu", history=HISTORY)
    assert set(a.data) == set(b.data)
    for k in a.data:
        x, y = a.data[k], b.data[k]
        assert type(x) is type(y), k
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype, k
        same(x, y, 0.0, k)
    for k in set(a.metadata) - {"fname"}:
        same(a.metadata[k], b.metadata[k], 0.0, k)
    assert b.metadata["fname"] == "" and a.device == b.device == torch.device("cpu")
    raw = composite_raw(d, 2, 4, HISTORY)
    assert TNT.histogram.from_composite(raw, d["curr_beta"], d["curr_mu"], 1, device="cpu").data["ntot"].dtype == np.int64


def test_default_device_is_the_card(nc31):
    p, d, _ = nc31
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TNT.histogram(p, d["curr_beta"], d["curr_mu"], 1)


# ---------------------------------------------------------------------------
# basic operations, segmentation and thermo


def test_normalize_reweight_mix(nc31):
    a, b = pair(nc31)
    a.normalize()
    b.normalize()
    same(a.data["ln(PI)"], b.data["ln(PI)"])
    a.reweight(MU2P)
    b.reweight(MU2P)
    same(_thermo_data(a), _thermo_data(b))
    a2, b2 = pair(nc31)
    a2.reweight(MU2P)
    b2.reweight(MU2P)
    a2.data["ln(PI)"] = a2.data["ln(PI)"] + 0.3 * np.arange(31) / 30
    b2.data["ln(PI)"] = b2.data["ln(PI)"] + 0.3 * np.arange(31) / 30
    am, bm = a.mix(a2, [0.7, 0.3]), b.mix(b2, [0.7, 0.3])
    same(_thermo_data(am), _thermo_data(bm))
    same(am.metadata, bm.metadata)
    with pytest.raises(Exception, match="Requires 2 weights"):
        a.mix(a2, [1.0])


@pytest.mark.parametrize("props", [True, False])
@pytest.mark.parametrize("mu", [-50.0, MU2P])
def test_relextrema_thermo_is_safe(nc31, mu, props):
    a, b = pair(nc31)
    a.reweight(mu)
    b.reweight(mu)
    a.thermo(props=props)
    b.thermo(props=props)
    same(_thermo_data(a), _thermo_data(b))
    assert len(a.data["thermo"]) == (2 if mu == MU2P else 1)
    assert a.is_safe() == b.is_safe() and a.is_safe(complete=True) == b.is_safe(complete=True)
    assert a.coexisting(0.5) == b.coexisting(0.5)
    assert a.coexisting() == b.coexisting()


def test_thermo_complete_and_janus_collect(nc31):
    a, b = pair(nc31)
    a.reweight(MU2P)
    b.reweight(MU2P)
    a.thermo(complete=True)
    b.thermo(complete=True)
    same(_thermo_data(a), _thermo_data(b))
    # three peaks: janus merges the first two into one macrophase
    x = np.linspace(0.0, 1.0, 31)
    y = 11.5 * np.exp(-((x - 0.15) ** 2) / 0.004) + 11.3 * np.exp(-((x - 0.45) ** 2) / 0.003) + 12 * np.exp(-((x - 0.8) ** 2) / 0.006)
    a, b = pair(nc31)
    a.data["ln(PI)"], b.data["ln(PI)"] = y.copy(), y.copy()
    a.thermo(collect=janus_collect)
    b.thermo(collect=jax_janus_collect)
    same(_thermo_data(a), _thermo_data(b))
    assert len(a.data["thermo"]) == 2 and len(b.data["thermo"]) == 2


def test_relextrema_failures_match(nc31):
    a, b = pair(nc31, smooth=0)
    for h in (a, b):
        with pytest.raises(Exception, match="smooth must be >= 1"):
            h.relextrema()
    a, b = pair(nc31)
    with pytest.raises(Exception, match="Thermodynamic properties should be called first"):
        a.coexisting()


# ---------------------------------------------------------------------------
# extrapolation and derivative exposures


@pytest.mark.parametrize("order", [1, 2, 3])
def test_temp_extrap(nc31, order):
    a, b = pair(nc31)
    a.reweight(MU2P)
    b.reweight(MU2P)
    ha, hb = a.temp_extrap(1.03, order, 10.0, False), b.temp_extrap(1.03, order, 10.0, False)
    same(_thermo_data(ha), _thermo_data(hb), 1e-11 if order == 3 else BAR)  # dB3 at 1e-11, as tests/test_torch_derivs.py
    ha.thermo()
    hb.thermo()
    same(ha.data["thermo"], hb.data["thermo"], 1e-11 if order == 3 else BAR)


@pytest.mark.parametrize("order", [1, 2])
def test_dmu_and_joint_extrap(nc31, order):
    a, b = pair(nc31)
    a.reweight(MU2P)
    b.reweight(MU2P)
    same(_thermo_data(a.dmu_extrap([-4.6], order, 10.0, False)), _thermo_data(b.dmu_extrap([-4.6], order, 10.0, False)))
    ha = a.temp_dmu_extrap(1.02, [-4.6], order, 10.0, False)
    hb = b.temp_dmu_extrap(1.02, [-4.6], order, 10.0, False)
    same(_thermo_data(ha), _thermo_data(hb))
    ga = a.temp_dmu_extrap_multi([0.98, 1.02], [[-5.2], [-4.6], [-4.4]], order, 10.0, False)
    gb = b.temp_dmu_extrap_multi([0.98, 1.02], [[-5.2], [-4.6], [-4.4]], order, 10.0, False)
    assert len(ga) == 2 and len(ga[0]) == 3
    for ra, rb in zip(ga, gb):
        for x, y in zip(ra, rb):
            same(_thermo_data(x), _thermo_data(y))


def test_find_phase_eq(nc31):
    """Nelder-Mead over both packages' objectives from the same start: the
    same mu* and the same two phases."""
    a, b = pair(nc31)
    ea = a.find_phase_eq(1e-8, 4.0)
    eb = b.find_phase_eq(1e-8, 4.0)
    same(ea.data["curr_mu"], eb.data["curr_mu"])
    assert len(ea.data["thermo"]) == 2
    fa = [ea.data["thermo"][p]["F.E./kT"] for p in ea.data["thermo"]]
    fb = [eb.data["thermo"][p]["F.E./kT"] for p in eb.data["thermo"]]
    same(fa, fb)
    assert abs(fa[0] - fa[1]) < 1e-2
    ea, erra = a.find_phase_eq(1e-8, 4.0, beta=1.01, dMu=[-4.8], reterr=True)
    eb, errb = b.find_phase_eq(1e-8, 4.0, beta=1.01, dMu=[-4.8], reterr=True)
    same(ea.data["curr_mu"], eb.data["curr_mu"])
    same(erra, errb)
    same(ea.data["thermo"], eb.data["thermo"])


def test_derivative_exposures(nc31):
    a, b = pair(nc31)
    v = np.linspace(0.0, 1.0, 31)
    N1, U = (0, 1, 0, 0, 0), (0, 0, 0, 0, 1)
    N2 = (1, 1, 0, 0, 0)
    scalars = [
        ("_gc_ave_v", (v,)), ("_gc_ave_i", (N2,)), ("_gc_fluct_vv", (v, v**2)), ("_gc_fluct_vi", (v, U)),
        ("_gc_fluct_iv", (U, v)), ("_gc_fluct_ii", (N1, N2)), ("_gc_dX_dB", (N2, 1)), ("_gc_d2X_dB2", (U,)),
        ("_gc_df_dB_ii", ((N1, 0), (U, 0))), ("_gc_df_dB_in", ((N2, 0), 1)),
    ]
    vectors = [
        ("_sg_dX_dB", (U,)), ("_sg_dX_dMU", (0, N1)), ("_sg_d2X_dB2", (N2,)), ("_sg_d2X_dMU2", (0, 0, N1)),
        ("_sg_d3X_dB3", (N1,)), ("_sg_df_dB", ((N1, 0), (U, 0))), ("_sg_df_dMU", (0, N1, U)), ("_sg_d2f_dB2", ((N1, 0), (N2, 0))),
        ("_order_mom_address", ((1, 1, 0, 2, 0),)), ("_mom_prod", (N1, N2)),
    ]
    for name, args in scalars + vectors:
        x, y = getattr(a, name)(*args), getattr(b, name)(*args)
        assert isinstance(x, float) == isinstance(y, float), name
        same(x, y, 1e-11 if name == "_sg_d3X_dB3" else BAR, name)
    for name in ("_dB", "_dB2", "_dB3", "_dMU", "_dMU2", "_dBMU", "_dBMU2"):
        same(getattr(a, name)(), getattr(b, name)(), 1e-11 if name == "_dB3" else BAR, name)


def test_exceptions_match(nc31, tmp_path):
    p, d, _ = nc31
    a, b = pair(nc31)
    a.reweight(MU2P)
    b.reweight(MU2P)
    for h in (a, b):
        once = h.temp_extrap(1.03, 1, 10.0, False, clone=False)
        with pytest.raises(Exception, match="Cannot extrapolate the same histogram class twice"):
            once.temp_extrap(1.05, 1, 10.0, False)
    a, b = pair(nc31)
    a.reweight(MU2P)
    b.reweight(MU2P)
    for h in (a, b):
        with pytest.raises(Exception, match="not high enough"):
            h.temp_extrap(1.03, 4, 10.0, False)
        with pytest.raises(Exception, match="No implementation"):
            h.temp_extrap(1.03, 4, 10.0, False, skip_mom=True)
    # reweighted far up, the tail becomes the maximum: the edge guard trips
    a, b = pair(nc31)
    a.reweight(200.0)
    b.reweight(200.0)
    for h in (a, b):
        with pytest.raises(AssertionError, match="edge effect"):
            h.temp_extrap(1.03, 1, 10.0, False)
        h.temp_extrap(1.03, 1, 10.0, True)  # override
    for cls in (TNT.histogram, JNT.histogram):
        kw = {"device": "cpu"} if cls is TNT.histogram else {}
        with pytest.raises(AssertionError, match="Different number of species"):
            cls(p, d["curr_beta"], [5.0], 1, **kw)
        with pytest.raises(Exception, match="Unable to load data"):
            cls(str(tmp_path / "missing.nc"), 1.0, [5.0, 0.0], 1, **kw)
        with pytest.raises(AssertionError, match="Illegal beta"):
            cls(p, -1.0, [5.0, 0.0], 1, **kw)


# ---------------------------------------------------------------------------
# n1: a make_n1_fixture-style composite (tests/test_gc_n1.py:22, copied)

N1_BETA, N1_MU = 1.0, [1.2, -0.4]


def make_n1_fixture(path, n=31, nspec=2, max_order=3):
    """A consistent N_1 composite: N_1 deterministic per bin, N_2 and U
    smooth profiles with inflated higher moments (two lnPI peaks)."""
    n1 = np.arange(n, dtype=float)
    n2 = 0.7 * n1 + 1.0 + 0.05 * np.sin(n1 / 3.0)
    u = -0.3 * n1 - 0.01 * n1**2
    lnpi = np.concatenate([np.linspace(0, 10, 11), np.linspace(10, 0, 10)[1:], np.linspace(0, 5, 6)[1:], np.linspace(5, 0, 7)[1:]])
    mo1 = max_order + 1
    vals = {}
    for a in range(2 * max_order + 1):
        for b in range(2 * max_order + 1):
            for p in range(mo1):
                infl = 1.0 + 0.02 * (a * (a - 1) + b * (b - 1) + p * (p - 1)) + 0.001 * (a * b + b * p)
                vals[(a, b, p)] = (n1**a) * (n2**b) * (u**p) * infl
    mom = np.zeros((nspec, mo1, nspec, mo1, mo1, n))
    for i in range(nspec):
        for j in range(mo1):
            for k in range(nspec):
                for m in range(mo1):
                    for p in range(mo1):
                        a = (j if i == 0 else 0) + (m if k == 0 else 0)
                        b = (j if i == 1 else 0) + (m if k == 1 else 0)
                        mom[i, j, k, m, p] = vals[(a, b, p)]
    pk = {"hist": np.full((nspec, n, 4), 0.25), "lb": np.zeros((nspec, n)), "ub": np.full((nspec, n), 3.0), "bw": np.ones((nspec, n))}
    eh = {"hist": np.full((n, 4), 0.25), "lb": np.zeros(n), "ub": np.full(n, 3.0), "bw": np.ones(n)}
    TIO.write_composite(str(path), lnpi, n1.astype(int), mom, volume=512.0, nspec=nspec, max_order=max_order, op_name="N_{1}", pk_hist=pk, e_hist=eh, history=HISTORY)


@pytest.fixture(scope="module")
def nc_n1(tmp_path_factory):
    p = tmp_path_factory.mktemp("n1") / "n1.nc"
    make_n1_fixture(p)
    return str(p)


def test_n1_class_matches_jax(nc_n1):
    a = TN1.histogram(nc_n1, N1_BETA, N1_MU, smooth=1, device="cpu")
    b = JN1.histogram(nc_n1, N1_BETA, N1_MU, smooth=1)
    same(_thermo_data(a), _thermo_data(b))
    a.reweight(1.5)
    b.reweight(1.5)
    same(_thermo_data(a), _thermo_data(b))
    assert a.data["curr_mu"][1] == N1_MU[1]  # only mu_1 moves
    a.thermo()
    b.thermo()
    same(a.data["thermo"], b.data["thermo"])
    assert len(a.data["thermo"]) == 2
    for order in (1, 2):
        ha = a.temp_mu_extrap(1.05, [-0.3], order, 10.0, True)
        hb = b.temp_mu_extrap(1.05, [-0.3], order, 10.0, True)
        same(_thermo_data(ha), _thermo_data(hb))
        ga = a.temp_mu_extrap_multi([0.95, 1.05], [[-0.5], [-0.3]], order, 10.0, True)
        gb = b.temp_mu_extrap_multi([0.95, 1.05], [[-0.5], [-0.3]], order, 10.0, True)
        for ra, rb in zip(ga, gb):
            for x, y in zip(ra, rb):
                same(_thermo_data(x), _thermo_data(y))
    ta, tb = a.temp_extrap(1.05, 2, 10.0, True), b.temp_extrap(1.05, 2, 10.0, True)
    same(_thermo_data(ta), _thermo_data(tb))
    for h in (a, b):
        with pytest.raises(AttributeError, match="absolute mu"):
            h.temp_dmu_extrap(1.05, [-0.3])
        with pytest.raises(Exception, match="collect hook"):
            h.thermo(collect=janus_collect)


def test_n1_find_phase_eq_matches_jax(nc_n1):
    a = TN1.histogram(nc_n1, N1_BETA, N1_MU, smooth=1, device="cpu")
    b = JN1.histogram(nc_n1, N1_BETA, N1_MU, smooth=1)
    ea, eb = a.find_phase_eq(1e-8, N1_MU[0]), b.find_phase_eq(1e-8, N1_MU[0])
    same(ea.data["curr_mu"], eb.data["curr_mu"])
    same(ea.data["thermo"], eb.data["thermo"])
    fe = [ea.data["thermo"][p]["F.E./kT"] for p in ea.data["thermo"]]
    assert len(fe) == 2 and abs(fe[0] - fe[1]) < 1e-2


def test_n1_requires_sub_histograms(nc_n1):
    raw = TIO.read_composite(nc_n1, op_name="N_{1}")
    raw.pop("pk_hist")
    with pytest.raises(Exception, match="sub-histograms"):
        TN1.histogram.from_composite(raw, N1_BETA, N1_MU, 1, device="cpu")
    h = TN1.histogram.from_composite(TIO.read_composite(nc_n1, op_name="N_{1}"), N1_BETA, N1_MU, 1, device="cpu")
    same(_thermo_data(h), _thermo_data(JN1.histogram(nc_n1, N1_BETA, N1_MU, smooth=1)))
    assert h.metadata["used_ke"] is False
