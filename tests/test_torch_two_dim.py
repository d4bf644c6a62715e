"""PyTorch port: the 2-D path end to end (two_dim.pore_state_sweep,
two_dim.joint_state_sweep, the class two_dim.pore_hist, and the host
modules joint_hist, organize, free_energy_profile, imaging) against the
JAX package's, on the same inputs, at both segment engines.

Bars: labels, n_phases, phase_ok, ridge_ok, peak_flat, elev_tie,
local_maxima and fail_code equal bit for bit; every float within 1e-12
absolute with NaN and +-inf in the same places.  Surfaces: the bench's
13 x 21 pore and a cut-down (24 x 97) bench joint surface, the tests'
two-basin joint surface (ragged, and with interior holes), random ragged
joints (test_segment2d.py _random_joint), and the fail-code surfaces
(saturated slots, no peaks, an exact elevation tie).
"""

import json

import numpy as np
import pytest
import torch

import fhmcanalysis_torch.native as TN
import fhmcanalysis_torch.two_dim as T2
import fhmcanalysis_torch.two_dim.imaging as TI
import fhmcanalysis_tpu.two_dim as J2
import fhmcanalysis_tpu.two_dim.imaging as JI
from fhmcanalysis_torch.parallel import grid_mesh
from test_segment2d import _random_joint
from torch_composites import (
    FH_COEFFS, JOINT_BETA, JOINT_MU_REF, TWO_BASIN_BETA, TWO_BASIN_MU_REF, joint, joint_class_oracle, joint_prod_entries,
    joint_states, pore13_entries, tie_joint, two_basin_entries,
)

torch.set_num_threads(1)
ATOL = 1e-12
P5 = (np.array([0.0, 0.05, 0.1, 0.0, 0.02]), np.array([1.0, 1.0, 1.0, 0.9, 1.1]))  # test_pore_pipeline.py's states
TARGETS = np.array([[0.2, -0.3], [0.5, -0.1], [-0.2, 0.4], [0.7, 0.2]])  # test_device_watershed.py's joint targets


def _np(x):
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _same(a, b, where, atol=ATOL):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape, (where, a.shape, b.shape)
    if a.dtype.kind != "f":
        np.testing.assert_array_equal(a, b, err_msg=where)
        return
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=where)
    np.testing.assert_array_equal(np.where(np.isinf(a), a, 0), np.where(np.isinf(b), b, 0), err_msg=where)
    fin = np.isfinite(a)
    np.testing.assert_allclose(a[fin], b[fin], rtol=0, atol=atol, err_msg=where)


def _same_sweep(j, t, where):
    """Every key of two sweep dicts (JAX's device arrays and the port's
    tensors come to numpy first)."""
    assert set(j) == set(t), (where, set(j) ^ set(t))
    assert j["prop_names"] == t["prop_names"]
    assert len(j["local_maxima"]) == len(t["local_maxima"])
    for a, b in zip(j["local_maxima"], t["local_maxima"]):
        np.testing.assert_array_equal(a, b, err_msg=where)
    for k in j:
        if k not in ("prop_names", "local_maxima"):
            _same(j[k], t[k], f"{where}: {k}")


def _port_joint(jh):
    """The port's joint_hist with the entries of a JAX one."""
    out = T2.joint_hist()
    for op1, e in jh.data["entries"].items():
        out.enter(op1, e.data["ln(PI)"], e.data["op_vals"], e.data["props"])
    return out


def _pore(pkg, entries, states, **kw):
    jh = joint(entries, pkg.joint_hist)
    fh = pkg.free_energy_profile.polynomial(FH_COEFFS)
    kw = dict(dict(nnebr=1, max_peaks=4), **kw)
    if pkg is T2:
        kw["device"] = "cpu"
    return pkg.pore_state_sweep(jh, fh.free_energy, states[0], states[1], 1.0, **kw)


def _joint(pkg, jh, targets, beta=TWO_BASIN_BETA, mu_ref=TWO_BASIN_MU_REF, **kw):
    kw = dict(dict(nnebr=1, max_peaks=4), **kw)
    if pkg is T2:
        kw["device"] = "cpu"
    return pkg.joint_state_sweep(jh, beta, mu_ref, targets, **kw)


# ----------------------------------------------------------------- sweeps


@pytest.mark.parametrize("return_surfaces", [True, False])
@pytest.mark.parametrize("engine", ["host", "device"])
def test_pore_sweep_matches_jax(engine, return_surfaces):
    j = _pore(J2, pore13_entries(), P5, segment_engine=engine, return_surfaces=return_surfaces)
    t = _pore(T2, pore13_entries(), P5, segment_engine=engine, return_surfaces=return_surfaces)
    _same_sweep(j, t, f"pore13 {engine}")
    assert (t["fail_code"] == 0).all() and (t["n_phases"] == 2).all()
    on_card = engine == "device" and not return_surfaces  # the surfaces stay tensors, as JAX leaves device arrays
    assert torch.is_tensor(t["lnpi"]) == on_card and torch.is_tensor(t["labels"]) == on_card
    assert isinstance(t["fe"], np.ndarray)


@pytest.mark.parametrize("engine", ["host", "device"])
def test_joint_sweep_matches_jax(engine):
    j = _joint(J2, joint(two_basin_entries(), J2.joint_hist), TARGETS, segment_engine=engine)
    t = _joint(T2, joint(two_basin_entries()), TARGETS, segment_engine=engine)
    _same_sweep(j, t, f"two-basin {engine}")


@pytest.mark.parametrize("engine", ["host", "device"])
def test_joint_holed_surface_matches_jax(engine):
    """test_joint_pipeline.py:97: non-contiguous op_2 entries leave -inf
    holes inside a row; the valid mask excludes them everywhere."""

    def holed(cls):
        jh = joint(two_basin_entries(), cls)
        e = jh.data["entries"][5.0]
        keep = ~np.isin(e.data["op_vals"], [10.0, 11.0, 12.0])
        jh.enter(5.0, e.data["ln(PI)"][keep], e.data["op_vals"][keep].astype(int), {k: v[keep] for k, v in e.data["props"].items()})
        return jh

    j = _joint(J2, holed(J2.joint_hist), TARGETS[:2], segment_engine=engine)
    t = _joint(T2, holed(T2.joint_hist), TARGETS[:2], segment_engine=engine)
    _same_sweep(j, t, f"holed {engine}")
    assert (t["labels"][0][5, 10:13] == 0).all() and int(t["n_phases"][0]) == 2


@pytest.mark.parametrize("engine", ["host", "device"])
def test_joint_bench_surface_matches_jax(engine):
    """bench.py's joint surface cut to 24 x 97 (as its test runs it), at
    its states, against JAX and against the class engine per state."""
    j = _joint(J2, joint(joint_prod_entries(24, 97), J2.joint_hist), joint_states(4), JOINT_BETA, JOINT_MU_REF, segment_engine=engine)
    jh = joint(joint_prod_entries(24, 97))
    jh.make()
    t = _joint(T2, jh, joint_states(4), JOINT_BETA, JOINT_MU_REF, segment_engine=engine)
    _same_sweep(j, t, f"joint bench {engine}")
    assert (t["fail_code"] == 0).all()
    for s in range(4):
        ph, props = joint_class_oracle(jh, JOINT_BETA, JOINT_MU_REF, joint_states(4)[s], 1, 4)
        n = int(t["n_phases"][s])
        np.testing.assert_array_equal(t["labels"][s], ph.data["seg"]["phase_labels"])
        for k in range(n):
            assert abs(t["fe"][s, k] - props[k]["F.E./kT"]) < 1e-10
        np.testing.assert_allclose(t["act_kT"][s, :n, :n], props["activation_kT"], rtol=0, atol=1e-10)


@pytest.mark.parametrize("engine", ["host", "device"])
def test_pore_random_joints_match_jax(engine):
    """Random ragged joints with 1-3 hills and random (p, beta): ridge-unsafe
    states (fail_code 1) among them."""
    rng = np.random.default_rng(5)
    codes = []
    for _ in range(3):
        jh = _random_joint(rng, H=11, N=23)
        coeffs = rng.uniform(-0.3, 0.3, size=2).tolist()
        ps, bs = rng.uniform(0.0, 0.2, size=4), rng.uniform(0.8, 1.2, size=4)
        kw = dict(nnebr=1, max_peaks=5, segment_engine=engine)
        j = J2.pore_state_sweep(jh, J2.free_energy_profile.polynomial(coeffs), ps, bs, 1.0, **kw)
        t = T2.pore_state_sweep(_port_joint(jh), T2.free_energy_profile.polynomial(coeffs), ps, bs, 1.0, device="cpu", **kw)
        _same_sweep(j, t, f"random {engine}")
        codes += t["fail_code"].tolist()
    assert 1 in codes


@pytest.mark.parametrize("engine", ["host", "device"])
def test_fail_codes_saturated_and_empty(engine):
    """fail_code 3 (more maxima than the max_peaks + 1 slots) and 2 (a flat
    surface: no peak above the minimum)."""
    ps, bs = np.array([0.0, 0.05]), np.array([1.0, 1.05])
    j = _pore(J2, pore13_entries(), (ps, bs), max_peaks=0, segment_engine=engine)
    t = _pore(T2, pore13_entries(), (ps, bs), max_peaks=0, segment_engine=engine)
    assert (t["fail_code"] == 3).all()
    if engine == "host":  # saturated device labels may legally differ (background where the flood spills)
        _same_sweep(j, t, "saturated")
    else:
        for k in ("fail_code", "n_phases", "elev_tie"):
            _same(j[k], t[k], f"saturated {k}")
    flat = [(op1, np.zeros_like(lnpi), ops, props) for op1, lnpi, ops, props in two_basin_entries()]
    at_ref = np.array([TWO_BASIN_MU_REF] * 2)  # no reweight: the surface stays flat
    j = _joint(J2, joint(flat, J2.joint_hist), at_ref, segment_engine=engine)
    t = _joint(T2, joint(flat), at_ref, segment_engine=engine)
    _same_sweep(j, t, "no peaks")
    assert (t["fail_code"] == 2).all() and (t["n_phases"] == 0).all()


@pytest.mark.parametrize("return_surfaces", [True, False])
def test_tie_flag_and_fallback(return_surfaces):
    """An exact within-row plateau: the device engine flags every state
    (fail_code 4); tie_fallback splices in the host flood's answer,
    into the on-card label tensor too when the surfaces stay there."""
    st = (P5[0][:3], P5[1][:3])
    fh_j, fh_t = J2.free_energy_profile.polynomial(FH_COEFFS), T2.free_energy_profile.polynomial(FH_COEFFS)
    jt_j, jt_t = tie_joint(joint(pore13_entries(), J2.joint_hist)), tie_joint(joint(pore13_entries()))
    kw = dict(nnebr=1, max_peaks=4, return_surfaces=return_surfaces)
    host = T2.pore_state_sweep(jt_t, fh_t, *st, 1.0, segment_engine="host", device="cpu", **kw)
    assert not host["elev_tie"].any()
    for fb in (False, True):
        j = J2.pore_state_sweep(jt_j, fh_j, *st, 1.0, segment_engine="device", tie_fallback=fb, **kw)
        t = T2.pore_state_sweep(jt_t, fh_t, *st, 1.0, segment_engine="device", tie_fallback=fb, device="cpu", **kw)
        _same_sweep(j, t, f"tie fallback={fb}")
        assert t["elev_tie"].all()
        assert (t["fail_code"] == (0 if fb else 4)).all()
    assert torch.is_tensor(t["labels"]) == (not return_surfaces)
    np.testing.assert_array_equal(_np(t["labels"]), _np(host["labels"]))
    for k in ("fe", "ave", "act_kT", "act_kT_diff"):
        _same(host[k], t[k], k)


@pytest.mark.parametrize("engine", ["host", "device"])
def test_empty_state_batch(engine):
    j = _joint(J2, joint(two_basin_entries(), J2.joint_hist), np.zeros((0, 2)), segment_engine=engine)
    t = _joint(T2, joint(two_basin_entries()), np.zeros((0, 2)), segment_engine=engine)
    _same_sweep(j, t, f"S=0 {engine}")
    assert t["fe"].shape == (0, 5) and t["fail_code"].shape == (0,) and t["local_maxima"] == []
    t = _pore(T2, pore13_entries(), (np.zeros(0), np.zeros(0)), segment_engine=engine)
    assert t["lnpi"].shape == (0, 13, 21) and t["ave"].shape == (0, 5, 2)


def test_engine_device_and_mesh_rules(monkeypatch):
    """"auto" is the host flood on the CPU; mesh= names the devices, so it
    raises beside device= (a mesh of CPU devices runs the host flood too;
    tests/test_torch_parallel.py holds it against JAX); no device means
    the card, which raises where there is none."""
    jt = tie_joint(joint(pore13_entries()))
    fh = T2.free_energy_profile.polynomial(FH_COEFFS)
    out = T2.pore_state_sweep(jt, fh, *P5, 1.0, nnebr=1, max_peaks=4, device="cpu")
    assert not out["elev_tie"].any()  # the host flood never flags
    mesh = grid_mesh(2, devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="not both"):
        T2.pore_state_sweep(jt, fh, *P5, 1.0, mesh=mesh, device="cpu")
    with pytest.raises(ValueError, match="not both"):
        T2.joint_state_sweep(joint(two_basin_entries()), 1.1, (0.2, -0.3), TARGETS, mesh=mesh, device="cpu")
    on_mesh = T2.pore_state_sweep(jt, fh, *P5, 1.0, nnebr=1, max_peaks=4, mesh=mesh)
    assert not on_mesh["elev_tie"].any()
    np.testing.assert_array_equal(on_mesh["labels"], out["labels"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        T2.pore_state_sweep(jt, fh, *P5, 1.0)
    with pytest.raises(RuntimeError):
        T2.pore_hist(jt, fh, 0.0, 1.0, 1.0)
    with pytest.raises(AssertionError):
        T2.pore_state_sweep(jt, fh, np.zeros(3), np.zeros(2), 1.0, device="cpu")


def test_made_input_not_mutated():
    jh = joint(two_basin_entries())
    jh.make()
    before = {k: np.array(v, copy=True) for k, v in jh.data.items() if k not in ("entries", "props")}
    a = _joint(T2, jh, TARGETS[:2])
    for k, v in before.items():
        np.testing.assert_array_equal(jh.data[k], v)
    raw = joint(two_basin_entries())
    b = _joint(T2, raw, TARGETS[:2])
    assert "ln(PI)" not in raw.data
    _same_sweep(a, b, "made vs unmade")


# ---------------------------------------------------------------- the class


def _class_pair(engine, p=0.05, beta=1.0):
    fh_j, fh_t = J2.free_energy_profile.polynomial(FH_COEFFS), T2.free_energy_profile.polynomial(FH_COEFFS)
    kw = {} if engine == "numpy" else {"device": "cpu"}
    return (J2.pore_hist(joint(pore13_entries(), J2.joint_hist), fh_j, p, 1.0, beta, engine=engine),
            T2.pore_hist(joint(pore13_entries()), fh_t, p, 1.0, beta, engine=engine, **kw))


def _same_props(a, b, where):
    assert sorted(k for k in a if isinstance(k, int)) == sorted(k for k in b if isinstance(k, int)), where
    for k in a:
        if isinstance(k, int):
            for prop in a[k]:
                if prop == "peak_idx":
                    for x, y in zip(a[k][prop], b[k][prop]):
                        np.testing.assert_array_equal(x, y, err_msg=where)
                else:
                    _same(a[k][prop], b[k][prop], f"{where} {k} {prop}")
        else:
            _same(a[k], b[k], f"{where} {k}")


@pytest.mark.parametrize("engine", ["device", "numpy"])
def test_pore_hist_matches_jax(engine):
    """normalize, thermo, phase_average (with _segment's transition
    states and line profiles) and width_phase_average."""
    j, t = _class_pair(engine)
    _same(j.data["ln(PI)"], t.data["ln(PI)"], "ln(PI)")
    rng = np.random.default_rng(3)
    for _ in range(3):
        mask = (rng.random(t.data["ln(PI)"].shape) < 0.4) & t._valid()
        a, b = j.thermo(mask), t.thermo(mask)
        for k in ("N_tot", "U"):
            _same(a[k], b[k], f"thermo {k}")
        for x, y in zip(a["peak_idx"], b["peak_idx"]):
            np.testing.assert_array_equal(x, y)
    _same_props(j.phase_average(nnebr=1, max_peaks=4), t.phase_average(nnebr=1, max_peaks=4), f"{engine} phase_average")
    for k in ("transition_state_kT", "max_border_kT", "phase_labels", "local_maxima", "line_profile", "line_profile_coords"):
        _same(j.data["seg"][k], t.data["seg"][k], f"seg {k}")
    _same_props(j.width_phase_average([6.5, 1000.0], nnebr=1, max_peaks=4), t.width_phase_average([6.5, 1000.0], nnebr=1, max_peaks=4), f"{engine} width")


def test_pore_hist_engines_randomized(rng):
    """The device engine against the numpy engine on random ragged joints
    (test_segment2d.py's TestPhaseAverage), raise semantics included."""
    n_ok = 0
    for _ in range(6):
        jh = _port_joint(_random_joint(rng, H=10, N=20))
        fh = T2.free_energy_profile.polynomial(rng.uniform(-0.5, 0.5, size=2).tolist())
        p, A, beta = float(rng.uniform(0.0, 0.3)), float(rng.uniform(0.5, 2.0)), float(rng.uniform(0.5, 2.0))
        dev = T2.pore_hist(jh, fh.free_energy, p, A, beta, device="cpu")
        host = T2.pore_hist(jh, fh.free_energy, p, A, beta, engine="numpy")
        _same(dev.data["ln(PI)"], host.data["ln(PI)"], "ln(PI)")
        try:
            b = host.phase_average(nnebr=1, max_peaks=6)
        except Exception as e:
            with pytest.raises(Exception, match="ridgeline|segment"):
                dev.phase_average(nnebr=1, max_peaks=6)
            assert "ridgeline" in str(e) or "segment" in str(e)
            continue
        a = dev.phase_average(nnebr=1, max_peaks=6)
        for k in (k for k in b if isinstance(k, int)):
            for prop in ("N_tot", "U", "F.E./kT"):
                assert abs(a[k][prop] - b[k][prop]) < 1e-10
        np.testing.assert_allclose(a["activation_kT"], b["activation_kT"], rtol=0, atol=1e-10)
        np.testing.assert_allclose(dev.data["seg"]["transition_state_kT"], host.data["seg"]["transition_state_kT"], rtol=0, atol=1e-10)
        n_ok += 1
    assert n_ok >= 2


# ------------------------------------------------------------ host modules


def test_joint_hist_json_round_trip(tmp_path):
    """The same JSON file from both packages, each loading the other's."""
    jj, tj = joint(two_basin_entries(), J2.joint_hist), joint(two_basin_entries())
    jj.make()
    tj.make()
    for k in ("ln(PI)", "op_1", "op_2", "bounds_idx"):
        np.testing.assert_array_equal(jj.data[k], tj.data[k])
    jj.to_json(str(tmp_path / "j.json"))
    tj.to_json(str(tmp_path / "t.json"))
    assert (tmp_path / "j.json").read_text() == (tmp_path / "t.json").read_text()
    back = T2.joint_hist()
    back.from_json(str(tmp_path / "j.json"))
    for k in ("ln(PI)", "op_1", "op_2", "bounds_idx"):
        np.testing.assert_array_equal(back.data[k], tj.data[k])
    a = _joint(T2, back, TARGETS[:2])
    b = _joint(T2, tj, TARGETS[:2])
    _same_sweep(a, b, "from_json")
    with pytest.raises(AssertionError, match="Missing props information"):
        (tmp_path / "bad.json").write_text(json.dumps({k: v for k, v in json.loads((tmp_path / "t.json").read_text()).items() if k != "props"}))
        T2.joint_hist().from_json(str(tmp_path / "bad.json"))


def test_joint_hist_entries_and_make():
    e = T2.joint_hist.entry()
    e.set_lnpi(np.array([1.0, 2.0, 3.0]), np.array([0, 1, 2]))
    with pytest.raises(AssertionError, match="Size of new property vector"):
        e.set_prop("bad", np.array([1.0, 2.0]))
    with pytest.raises(AssertionError, match="not sorted"):
        e.set_lnpi(np.array([1.0, 2.0, 3.0]), np.array([2, 1, 0]))
    for cls in (J2.joint_hist, T2.joint_hist):
        h = cls()
        h.enter(1, np.array([1.0, 2, 3]), np.array([1, 2, 3]), {"U": np.arange(3.0)})
        h.enter(2, np.array([0.0, 1, 2, 3, 4]), np.array([0, 1, 2, 3, 4]), {"U": np.arange(5.0)})
        h.make()
        np.testing.assert_array_equal(h.data["ln(PI)"], [[-np.inf, 1, 2, 3, -np.inf], [0, 1, 2, 3, 4]])
        h.enter(3, np.array([1.0]), np.array([0]), {"U": np.zeros(1)})
        assert "ln(PI)" not in h.data  # adding after make drops the assembly


def test_organize_and_free_energy_profile(tmp_path):
    """The phase organizer's JSON report and both F(h) providers, byte for
    byte and value for value against the JAX package's."""
    steps = [
        (0.1, 1.0, [10.0, 30.0], [[0.5], [0.6]], [-5.0, -15.0], [1.0, 2.0], [[2, 5], [9, 15]], [3.0, 9.0], [[0, 1.5], [1.5, 0]], [[0, 0.5], [0.5, 0]]),
        (0.2, 1.0, [11.0, 31.0], [[0.5], [0.6]], [-5.5, -15.5], [1.1, 1.9], [[2, 6], [9, 16]], [3.1, 9.1], [[0, 1.4], [1.4, 0]], [[0, 0.4], [0.4, 0]]),
        (0.3, 1.0, [12.0], [[0.5]], [-6.0], [1.2], [[3, 6]], [3.2], [[0]], [[0]]),
    ]
    for pkg, name in ((J2, "j"), (T2, "t")):
        org = pkg.organize.phase_organizer(axes_ratio=0.5, nPix=3, max_phases=4)
        for s in steps:
            org.add(s)
        org.print_org(str(tmp_path / name), comments="a sweep")
    assert (tmp_path / "j.json").read_text() == (tmp_path / "t.json").read_text()
    h = np.linspace(0.5, 12.5, 25)
    assert np.array_equal(J2.free_energy_profile.polynomial([0.3, -0.1, 2.0])(h), T2.free_energy_profile.polynomial([0.3, -0.1, 2.0])(h))
    np.savetxt(tmp_path / "fh.dat", np.stack([np.arange(1.0, 11.0), np.sin(np.arange(10.0))], 1))
    fj, ft = J2.free_energy_profile.interp(str(tmp_path / "fh.dat")), T2.free_energy_profile.interp(str(tmp_path / "fh.dat"))
    assert np.array_equal(fj(h), ft(h))


def test_imaging_native_and_heapq_floods(monkeypatch):
    """The native flood builds here and equals the heapq flood and JAX's
    imaging on the test surfaces; peak_local_max, find_boundaries and
    profile_line equal JAX's."""
    from torch_composites import rand_surface

    from fhmcanalysis_torch.two_dim.pore_pipeline import _footprint

    assert TN.IMAGING_AVAILABLE
    rng = np.random.RandomState(4)
    for H, N in ((13, 21), (30, 61)):
        x = rand_surface(rng, H, N, 4)
        x -= x.min()
        fp = _footprint(H, N, 1)
        valid = np.arange(N)[None, :] <= np.clip(rng.randint(N // 2, N, size=H), 1, N - 1)[:, None]
        lm = TI.peak_local_max(x, min_distance=1, exclude_border=0, num_peaks=6, footprint=fp)
        np.testing.assert_array_equal(lm, JI.peak_local_max(x, min_distance=1, exclude_border=0, num_peaks=6, footprint=fp))
        markers = np.zeros((H, N), int)
        for i, (r, c) in enumerate(lm):
            markers[r, c] = i + 1
        native = TI.watershed(-x, markers=markers, mask=valid, connectivity=fp)
        np.testing.assert_array_equal(native, JI.watershed(-x, markers=markers, mask=valid, connectivity=fp))
        with monkeypatch.context() as m:
            m.setattr(TN, "watershed_native", lambda *a: None)
            np.testing.assert_array_equal(native, TI.watershed(-x, markers=markers, mask=valid, connectivity=fp))
        np.testing.assert_array_equal(TI.find_boundaries(native), JI.find_boundaries(native))
        np.testing.assert_array_equal(TI.profile_line(x, (0, 0), (H, N)), JI.profile_line(x, (0, 0), (H, N)))
