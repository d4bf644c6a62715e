"""PyTorch port: parallel/ (the device-list mesh and the long-surface
halo exchange) against the JAX package, on the CPU.

The JAX side runs on the eight virtual CPU devices of tests/conftest.py
(its "auto" / XLA arms and its single-device functions; its "pallas" arms
emulate the TPU kernels and are never run here).  The port's stand-in is
``grid_mesh(8, devices=["cpu"] * 8)``, and 2- and 3-device meshes whose
blocks are uneven.  Every sharded function is held:

- against its JAX counterpart on the same seeded inputs: segmentation
  (left, right, mask, n_phases, valid, fail_code, labels, local maxima)
  and the stencil flags and extrema equal bit for bit; floats within the
  bar the path already holds against JAX: 1e-12 (absolute, or relative to
  max(1, |v|) where a field exceeds 1e2, as tests/test_torch_mb.py), the
  order-2 sweep 1e-10, the isopleth's F.E./kT 1e-11 at order 1 and every
  field 1e-10 at order 2, mu* 1e-9, the normalizations 1e-13 (JAX's own 2-D
  bar, tests/test_sharded_surface.py);
- against the port's own single-device call: bit for bit.  Every sharded
  route runs the single-device function on a block of independent points.
  Two exceptions: the normalizations add per-shard partial sums in another
  order (held to 1e-13 like JAX's); and the 2-D sweeps' per-phase
  averages are one einsum over the state batch (segment2d.pore_phase_batch),
  a matrix product whose blocking follows the batch's size, so their floats
  are held to 1e-12 (integers, labels and local maxima bit for bit).

Also: grid_mesh's factoring, replicate / shard_axis round trips, every
"not divisible" ValueError with JAX's message, device= with mesh=, and
grid_mesh() raising without a CUDA device.
"""

import numpy as np
import pytest
import torch

import fhmcanalysis_torch.core.numerics as TN
import fhmcanalysis_torch.core.pipeline as TP
import fhmcanalysis_torch.core.segment as TSg
import fhmcanalysis_torch.core.segment2d as TS2
import fhmcanalysis_torch.core.solve as TSV
import fhmcanalysis_torch.core.state as TS
import fhmcanalysis_torch.parallel as TPar
import fhmcanalysis_torch.two_dim as T2
import fhmcanalysis_tpu.core.state as JS
import fhmcanalysis_tpu.parallel as JPar
import fhmcanalysis_tpu.two_dim as J2
from fhmcanalysis_torch.binary import isopleth
from fhmcanalysis_torch.histogram.ntot import histogram
from fhmcanalysis_torch.io import write_composite
from fhmcanalysis_tpu.binary import isopleth as jax_isopleth
from fhmcanalysis_tpu.histogram.ntot import histogram as jax_histogram
from torch_composites import (
    FH_COEFFS, ISO31, TWO_BASIN_BETA, TWO_BASIN_MU_REF, cell, iso_grid_args, iso_sources, joint, pore13_entries, two_basin_entries,
)

import jax
import jax.numpy as jnp

torch.set_num_threads(1)
SEG = ("valid", "mask", "n_phases", "left", "right")
LNPI = np.array([0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 9, 8, 7, 6, 5, 4, 3, 2, 1, 0, 1, 2, 3, 4, 5, 4, 3, 2, 1, 0], dtype=np.float64)  # test_solve.py's
TRACE_BETAS = np.linspace(0.99, 1.01, 8)
P5 = (np.array([0.0, 0.05, 0.1, 0.0, 0.02]), np.array([1.0, 1.0, 1.0, 0.9, 1.1]))  # test_pore_pipeline.py's states
TARGETS5 = np.array([[0.2, -0.3], [0.5, -0.1], [-0.2, 0.4], [0.45, -0.2], [0.3, 0.0]])  # test_joint_pipeline.py's
GRID31 = iso_grid_args(ISO31, NX=16, NY=8)
NORM_BAR = 1e-13


def tmesh(n):
    return TPar.grid_mesh(n, devices=["cpu"] * n)


@pytest.fixture(scope="module")
def jmesh():
    assert len(jax.devices()) >= 8, "tests/conftest.py gives JAX eight virtual CPU devices"
    return JPar.grid_mesh(8)


def _np(x):
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _worst(got, want, ok):
    """max |got - want| over ``ok`` slots, relative to max(1, |want|) where
    the field exceeds 1e2 (equal values, +inf included, differ by 0)."""
    g, w, ok = _np(got), _np(want), _np(ok)
    okx = ok.reshape(ok.shape + (1,) * (w.ndim - ok.ndim))
    g, w = np.where(okx, g, 0.0), np.where(okx, w, 0.0)
    with np.errstate(invalid="ignore"):
        d = np.where(g == w, 0.0, np.abs(g - w))
    if np.max(np.abs(w), initial=0.0) > 1e2:
        d = d / np.maximum(1.0, np.abs(w))
    return float(d.max()) if d.size else 0.0


def _sweep_vs_jax(got, want, bar):
    """A port sweep dict against a JAX one: segmentation equal, floats
    within ``bar`` on real phases."""
    assert set(got) == set(want), set(got) ^ set(want)
    for k in SEG:
        np.testing.assert_array_equal(_np(got[k]), _np(want[k]), err_msg=k)
    ok = _np(want["mask"])
    for k in set(got) - set(SEG):
        assert _worst(got[k], want[k], ok) <= bar, k


def _equal(got, want):
    """Two port dicts of tensors (or arrays), bit for bit."""
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(_np(got[k]), _np(want[k]), err_msg=k)


# ------------------------------------------------------------------ the mesh


def test_public_names():
    assert TPar.__all__ == JPar.__all__ and len(TPar.__all__) == 13
    for name in TPar.__all__:
        assert callable(getattr(TPar, name)), name


@pytest.mark.parametrize("n", [1, 2, 3, 4, 6, 8])
def test_grid_mesh_factoring(jmesh, n):
    """The most-square (a, b) split of JAX's grid_mesh, devices in order."""
    got, want = tmesh(n), JPar.grid_mesh(n)
    assert got.axis_names == tuple(want.axis_names) == ("mu", "state")
    assert got.shape == dict(want.shape) and got.devices.shape == want.devices.shape
    assert got.size == n and got.device_list() == [torch.device("cpu")] * n
    assert got.axis_devices("mu") == list(got.devices[:, 0]) and got.axis_devices("state") == list(got.devices[0, :])


def test_grid_mesh_needs_cuda_or_a_list(monkeypatch):
    """Without a device list grid_mesh takes the CUDA devices, and raises
    where there are none rather than using the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TPar.grid_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TPar.grid_mesh(4)
    for bad in (0, 9):
        with pytest.raises(ValueError, match="n_devices"):
            TPar.grid_mesh(bad, devices=["cpu"] * 8)
    with pytest.raises(ValueError, match="axis_name"):
        tmesh(2).axis_devices("beta")


def test_replicate_and_shard_axis_round_trip(jmesh):
    d, mk, mus = cell("n31", 10)
    h = TS.from_host(d, device="cpu")
    for n in (1, 3, 8):
        mesh = tmesh(n)
        copies = TPar.replicate(mesh, h)
        assert len(copies) == n and all(c is copies[0] for c in copies)  # one device: one copy shared
        for f in ("lnpi", "mom", "op", "curr_mu", "curr_beta", "volume"):
            assert torch.equal(getattr(copies[-1], f), getattr(h, f))
        tree = TPar.replicate(mesh, {"h": h, "pair": (torch.arange(3), np.ones(2)), "n": 7})
        assert len(tree) == n and tree[0]["n"] == 7 and torch.equal(tree[0]["pair"][1], torch.ones(2, dtype=torch.float64))
        assert isinstance(tree[0]["pair"], tuple) and isinstance(tree[0]["h"], TS.Hist)
    # blocks of the leading axis along each mesh axis: grid_mesh(6) is 2 x 3,
    # so 10 values make [5, 5] along "mu" and [4, 3, 3] along "state"
    mesh = tmesh(6)
    x = torch.as_tensor(mus)
    for axis, sizes in (("mu", [5, 5]), ("state", [4, 3, 3])):
        blocks = TPar.shard_axis(mesh, x, axis)
        assert [len(b) for b in blocks] == sizes and torch.equal(torch.cat(blocks), x)
    assert [len(b) for b in TPar.shard_axis(tmesh(8), x[:3], "state")] == [1, 1, 1]  # empty blocks dropped
    # the JAX package's sharded array holds the same blocks (an even split there)
    jx = JPar.shard_axis(jmesh, jnp.asarray(mus[:8]), "state")
    want = sorted({(s.index[0].start or 0): np.asarray(s.data) for s in jx.addressable_shards}.items())
    got = TPar.shard_axis(tmesh(8), mus[:8], "state")
    assert len(got) == len(want) == jmesh.shape["state"]
    for g, (_, w) in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)


# ------------------------------------------------------------- state sweeps


@pytest.fixture(scope="module")
def n31():
    d, mk, mus = cell("n31", 48, max_order=3)
    return TS.from_host(d, device="cpu"), TS.HistMeta(**mk), JS.make_hist(**d), JS.HistMeta(**mk), mus, d


@pytest.mark.parametrize("props", [True, False])
def test_shard_map_mu_sweep(jmesh, n31, props):
    th, tm, jh, jm, mus, _ = n31
    want, want_min = JPar.shard_map_mu_sweep(jmesh, jh, jm, mus, props=props)
    single = TP.mu_sweep_thermo(th, tm, mus, props=props)
    for n in (8, 2, 3):
        got, got_min = TPar.shard_map_mu_sweep(tmesh(n), th, tm, mus, props=props)
        _sweep_vs_jax(got, want, 1e-12)
        _equal(got, single)
        assert float(got_min) == float(torch.where(single["mask"], single["fe"], torch.inf).min())
        assert abs(float(got_min) - float(want_min)) <= 1e-12


@pytest.mark.parametrize("order", [1, 2])
def test_sharded_mu_beta_sweep(jmesh, n31, order):
    """20 mu over 8 devices (blocks of 3 and 2) and 3 (7, 7, 6), against
    JAX's GSPMD arm (20 mu over its "mu" axis of 2, 4 targets over "state")."""
    th, tm, jh, jm, mus, d = n31
    betas = np.linspace(0.92, 1.08, 4)
    dmus = (d["curr_mu"][1:] - d["curr_mu"][0]) + np.linspace(-0.5, 0.5, 4)[:, None]
    want, want_min = JPar.sharded_mu_beta_sweep(jmesh, jh, jm, mus[:20], betas, dmus, order=order)
    single = TP.mu_beta_sweep_thermo(th, tm, mus[:20], betas, dmus, order=order)
    for n in (8, 3):
        got, got_min = TPar.sharded_mu_beta_sweep(tmesh(n), th, tm, mus[:20], betas, dmus, order=order)
        assert got["fe"].shape[:2] == (20, 4)
        _sweep_vs_jax(got, want, 1e-12 if order == 1 else 1e-10)
        _equal(got, single)
        assert abs(float(got_min) - float(want_min)) <= 1e-12


def test_sweep_engines(n31):
    """engine as the single-device call: "torch" is the plain version,
    "cuda" (and JAX's "pallas", which means it) raise for CPU devices,
    anything else raises naming the port's engines."""
    th, tm, _, _, mus, d = n31
    mesh = tmesh(2)
    dmus = (d["curr_mu"][1:] - d["curr_mu"][0])[None]
    a, _ = TPar.shard_map_mu_sweep(mesh, th, tm, mus, engine="torch")
    _equal(a, TP.mu_sweep_thermo(th, tm, mus))
    for engine in ("cuda", "pallas"):
        with pytest.raises(ValueError, match="CUDA"):
            TPar.sharded_mu_beta_sweep(mesh, th, tm, mus, [1.0], dmus, engine=engine)
    with pytest.raises(ValueError, match="CUDA"):
        TPar.shard_map_mu_sweep(mesh, th, tm, mus, engine="cuda")
    with pytest.raises(ValueError, match="'auto', 'torch' or 'cuda'"):
        TPar.sharded_mu_beta_sweep(mesh, th, tm, mus, [1.0], dmus, engine="xla")


@pytest.fixture(scope="module")
def lnpi_state():
    d, mk, _ = cell("n31", 1, max_order=3)
    d, mk = dict(d, lnpi=LNPI), dict(mk, max_phases=8)
    return TS.from_host(d, device="cpu"), TS.HistMeta(**mk), JS.make_hist(**d), JS.HistMeta(**mk)


def test_sharded_trace_coexistence(jmesh, lnpi_state):
    """8 temperatures over 8, 2 and 4 devices against JAX's sharded trace
    (mu* 1e-9, the rest at the solver's bars) and the port's one-device
    trace bit for bit; a guess or a dMu per temperature is split with
    them."""
    th, tm, jh, jm = lnpi_state
    kw = dict(lnZ_tol=1e-6, min_width=2)
    want = {k: np.asarray(v) for k, v in JPar.sharded_trace_coexistence(jmesh, jh, jm, TRACE_BETAS, 5.0, **kw).items()}
    single = TSV.trace_coexistence(th, tm, TRACE_BETAS, 5.0, **kw)
    assert single["converged"].all()
    for n in (8, 2):
        got = TPar.sharded_trace_coexistence(tmesh(n), th, tm, TRACE_BETAS, 5.0, **kw)
        assert set(got) == set(want)
        for k in ("mask", "converged"):
            np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
        assert np.abs(got["mu_star"].numpy() - want["mu_star"]).max() <= 1e-9
        assert np.abs(got["err"].numpy() - want["err"]).max() <= 1e-12
        for k in ("fe", "density", "x_i", "ntot", "u"):
            assert _worst(got[k], want[k], want["mask"]) <= 1e-12, k
        _equal(got, single)
    guesses = np.linspace(4.9, 5.1, 8)
    _equal(TPar.sharded_trace_coexistence(tmesh(4), th, tm, TRACE_BETAS, guesses, **kw), TSV.trace_coexistence(th, tm, TRACE_BETAS, guesses, **kw))
    dmus = (th.curr_mu[1:] - th.curr_mu[0]).numpy() + np.linspace(-0.02, 0.02, 8)[:, None]  # a dMu per temperature
    _equal(TPar.sharded_trace_coexistence(tmesh(2), th, tm, TRACE_BETAS, 5.0, dmu=dmus, **kw), TSV.trace_coexistence(th, tm, TRACE_BETAS, 5.0, dmu=dmus, **kw))


# ---------------------------------------------------------------- isopleths


@pytest.fixture(scope="module")
def iso_files(tmp_path_factory):
    root = tmp_path_factory.mktemp("iso_par")
    ds, mk = iso_sources("n31", (-5.0, -4.0), 3)
    paths = []
    for j, d in enumerate(ds):
        p = str(root / f"src{j}.nc")
        write_composite(p, d["lnpi"], d["op"], d["mom"], d["volume"], mk["nspec"], mk["max_order"], history="synthetic composite")
        paths.append((p, d))

    def get(cls, **kw):
        return [cls(p, d["curr_beta"], d["curr_mu"], mk["smooth"], mk["used_ke"], **kw) for p, d in paths]

    return get


@pytest.mark.parametrize("order", [1, 2])
def test_make_grid_mesh(jmesh, iso_files, order):
    """16 mu_1 columns over 8 devices (2 each) and 3 (6, 5, 5) against
    JAX's make_grid(mesh=) on its XLA engine and the port's one-device
    grid; mu1_chunk=2 keeps its meaning inside each block."""
    b = jax_isopleth(iso_files(jax_histogram), ISO31["beta"], order=order)
    b.make_grid(*GRID31, mesh=jmesh)
    one = isopleth(iso_files(histogram, device="cpu"), ISO31["beta"], order=order)
    one.make_grid(*GRID31)
    ok = b.data["valid"].astype(bool)
    assert ok.mean() >= 0.3
    bars = {"Z": 1e-12, "density": 1e-12, "F.E./kT": 1e-11} if order == 1 else dict.fromkeys(("Z", "density", "F.E./kT"), 1e-10)
    for n, chunk in ((8, None), (3, None), (3, 2)):
        a = isopleth(iso_files(histogram, device="cpu"), ISO31["beta"], order=order)
        if chunk is None:
            Z, (X, Y) = a.make_grid(*GRID31, mesh=tmesh(n))
        else:
            Z, (X, Y) = TPar.sharded_make_grid(tmesh(n), a, *GRID31, mu1_chunk=chunk)
        assert Z.shape == X.shape == Y.shape == (GRID31 and b.data["Z"].shape)
        for k in ("X", "Y", "valid", "fail_code"):
            np.testing.assert_array_equal(a.data[k], b.data[k], err_msg=k)
        for k, bar in bars.items():
            assert np.max(np.abs(np.where(ok, a.data[k] - b.data[k], 0.0))) <= bar, k
        for k in ("X", "Y", "Z", "density", "F.E./kT", "valid", "fail_code"):
            np.testing.assert_array_equal(a.data[k], one.data[k], err_msg=k)


def test_make_grid_engine_on_cpu_mesh(iso_files):
    a = isopleth(iso_files(histogram, device="cpu"), ISO31["beta"], order=1)
    with pytest.raises(ValueError, match="CUDA"):
        a.make_grid(*GRID31, mesh=tmesh(2), engine="cuda")


# -------------------------------------------------------------- 2-D sweeps


def _sweeps_equal(got, want, atol=0.0):
    """Two sweep dicts: integers and local maxima equal, floats within atol
    (0: bit for bit) with NaN and +-inf in the same places."""
    assert set(got) == set(want), set(got) ^ set(want)
    assert got["prop_names"] == want["prop_names"]
    assert len(got["local_maxima"]) == len(want["local_maxima"])
    for a, b in zip(got["local_maxima"], want["local_maxima"]):
        np.testing.assert_array_equal(_np(a), _np(b))
    for k in set(got) - {"prop_names", "local_maxima"}:
        a, b = _np(got[k]), _np(want[k])
        assert a.shape == b.shape, (k, a.shape, b.shape)
        if a.dtype.kind != "f" or atol == 0.0:
            np.testing.assert_array_equal(a, b, err_msg=k)
            continue
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=k)
        np.testing.assert_array_equal(np.where(np.isinf(a), a, 0), np.where(np.isinf(b), b, 0), err_msg=k)
        fin = np.isfinite(a)
        np.testing.assert_allclose(a[fin], b[fin], rtol=0, atol=atol, err_msg=k)


def _pore(pkg, mesh=None, **kw):
    fh = pkg.free_energy_profile.polynomial(FH_COEFFS)
    jh = joint(pore13_entries(), pkg.joint_hist)
    kw = dict(nnebr=1, max_peaks=4, **kw)
    if mesh is None:
        return pkg.pore_state_sweep(jh, fh.free_energy, P5[0], P5[1], 1.0, **kw)
    return pkg.parallel.sharded_pore_state_sweep(mesh, jh, fh.free_energy, P5[0], P5[1], 1.0, **kw) if pkg is JPar else TPar.sharded_pore_state_sweep(mesh, jh, fh.free_energy, P5[0], P5[1], 1.0, **kw)


@pytest.mark.parametrize("return_surfaces", [True, False])
@pytest.mark.parametrize("engine", ["host", "device"])
def test_sharded_pore_state_sweep(jmesh, engine, return_surfaces):
    """5 states over 8 devices (5 blocks of one), 2 and 3: JAX's sharded
    sweep and the port's one-device sweep (the 1e-12 bar of
    tests/test_torch_two_dim.py; integers bit for bit), the mesh= argument
    and the sharded function alike."""
    fh_j = J2.free_energy_profile.polynomial(FH_COEFFS)
    want = JPar.sharded_pore_state_sweep(jmesh, joint(pore13_entries(), J2.joint_hist), fh_j.free_energy, P5[0], P5[1], 1.0, nnebr=1, max_peaks=4, segment_engine=engine, return_surfaces=return_surfaces)
    fh = T2.free_energy_profile.polynomial(FH_COEFFS)
    kw = dict(nnebr=1, max_peaks=4, segment_engine=engine, return_surfaces=return_surfaces)
    single = T2.pore_state_sweep(joint(pore13_entries()), fh.free_energy, P5[0], P5[1], 1.0, device="cpu", **kw)
    for n in (8, 2, 3):
        got = TPar.sharded_pore_state_sweep(tmesh(n), joint(pore13_entries()), fh.free_energy, P5[0], P5[1], 1.0, **kw)
        _sweeps_equal(got, single, atol=1e-12)
        _sweeps_equal(got, want, atol=1e-12)
    via_arg = T2.pore_state_sweep(joint(pore13_entries()), fh.free_energy, P5[0], P5[1], 1.0, mesh=tmesh(3), **kw)
    _sweeps_equal(via_arg, single, atol=1e-12)
    assert (single["fail_code"] == 0).all() and (single["n_phases"] == 2).all()


@pytest.mark.parametrize("engine", ["host", "device"])
def test_sharded_joint_state_sweep(jmesh, engine):
    want = JPar.sharded_joint_state_sweep(jmesh, joint(two_basin_entries(), J2.joint_hist), TWO_BASIN_BETA, TWO_BASIN_MU_REF, TARGETS5, nnebr=1, max_peaks=4, segment_engine=engine)
    kw = dict(nnebr=1, max_peaks=4, segment_engine=engine)
    single = T2.joint_state_sweep(joint(two_basin_entries()), TWO_BASIN_BETA, TWO_BASIN_MU_REF, TARGETS5, device="cpu", **kw)
    for n in (8, 3):
        got = TPar.sharded_joint_state_sweep(tmesh(n), joint(two_basin_entries()), TWO_BASIN_BETA, TWO_BASIN_MU_REF, TARGETS5, **kw)
        _sweeps_equal(got, single, atol=1e-12)
        _sweeps_equal(got, want, atol=1e-12)
    via_arg = T2.joint_state_sweep(joint(two_basin_entries()), TWO_BASIN_BETA, TWO_BASIN_MU_REF, TARGETS5, mesh=tmesh(2), **kw)
    _sweeps_equal(via_arg, single, atol=1e-12)


def test_two_dim_mesh_with_device_raises():
    fh = T2.free_energy_profile.polynomial(FH_COEFFS)
    with pytest.raises(ValueError, match="not both"):
        T2.pore_state_sweep(joint(pore13_entries()), fh.free_energy, P5[0], P5[1], 1.0, mesh=tmesh(2), device="cpu")
    with pytest.raises(ValueError, match="not both"):
        T2.joint_state_sweep(joint(two_basin_entries()), TWO_BASIN_BETA, TWO_BASIN_MU_REF, TARGETS5, mesh=tmesh(2), device="cpu")


# ------------------------------------------------------- long surfaces


def _long_surface(rng, n):
    """tests/test_sharded_surface.py's three-peak surface with noise."""
    x = np.linspace(0, 1, n)
    y = sum(a * np.exp(-((x - c) ** 2) / w) for c, w, a in zip([0.15, 0.5, 0.82], [0.003, 0.01, 0.004], [40.0, 25.0, 55.0]))
    return y + rng.normal(size=n) * 0.2


@pytest.fixture(scope="module")
def long_lnpi():
    return _long_surface(np.random.default_rng(42), 1024)


def test_sharded_normalize_long(jmesh, long_lnpi):
    want = np.asarray(JPar.sharded_normalize_long(jmesh, jnp.asarray(long_lnpi)))
    single = TN.normalize_lnpi(torch.as_tensor(long_lnpi)).numpy()
    for n in (8, 2):
        blocks = TPar.sharded_normalize_long(tmesh(n), long_lnpi)
        assert len(blocks) == n and all(len(b) == 1024 // n for b in blocks)
        got = torch.cat(blocks).numpy()
        assert np.abs(got - want).max() <= NORM_BAR and np.abs(got - single).max() <= NORM_BAR


@pytest.mark.parametrize("smooth", [1, 5, 60, 200])
def test_sharded_stencil_flags(jmesh, long_lnpi, smooth):
    """1,024 bins: 128 a block over 8 devices, where smooth = 200 takes the
    gathered fallback (the halo wider than a block); 512 over 2."""
    wm, wn = JPar.sharded_stencil_flags(jmesh, jnp.asarray(long_lnpi), smooth)
    sm, sn = TSg.stencil_flags(torch.as_tensor(long_lnpi)[None], smooth)
    for n in (8, 2):
        gm, gn = TPar.sharded_stencil_flags(tmesh(n), long_lnpi, smooth)
        assert len(gm) == len(gn) == n
        for g, w, s in ((gm, wm, sm), (gn, wn, sn)):
            np.testing.assert_array_equal(torch.cat(g).numpy(), np.asarray(w))
            assert torch.equal(torch.cat(g), s[0])


def _extrema_equal(got, want):
    for f in ("maxima", "n_max", "minima", "n_min", "valid"):
        np.testing.assert_array_equal(_np(getattr(got, f)), _np(getattr(want, f)), err_msg=f)


@pytest.mark.parametrize("smooth", [3, 50])
def test_sharded_relextrema(jmesh, long_lnpi, smooth):
    want = JPar.sharded_relextrema(jmesh, jnp.asarray(long_lnpi), smooth, max_phases=8)
    single = TSg.relextrema(torch.as_tensor(long_lnpi)[None], smooth, 8)
    for n in (8, 2):
        got = TPar.sharded_relextrema(tmesh(n), long_lnpi, smooth, max_phases=8)
        _extrema_equal(got, want)
        _extrema_equal(got, TSg.Extrema(**{f: getattr(single, f)[0] for f in ("maxima", "n_max", "minima", "n_min", "valid")}))


def test_sharded_relextrema_endpoint_cases(jmesh):
    """Monotonic and endpoint-peaked surfaces take the repair branches."""
    n = 256
    for lnpi in (np.linspace(5.0, -40.0, n), np.concatenate([np.linspace(-5.0, 10.0, n // 2), np.linspace(10.0, -30.0, n // 2)])):
        want = JPar.sharded_relextrema(jmesh, jnp.asarray(lnpi), 3, max_phases=8)
        _extrema_equal(TPar.sharded_relextrema(tmesh(8), lnpi, 3, max_phases=8), want)


def test_sharded_normalize_2d(jmesh):
    """A ragged pore-style surface, 16 h-rows x 96 N-bins: 2 rows a shard."""
    rng = np.random.default_rng(42)
    H, N = 16, 96
    lnpi = rng.normal(size=(H, N)) * 3.0
    edge = rng.integers(N // 2, N, size=H)
    mask = np.arange(N)[None, :] <= edge[:, None]
    lnpi_m = np.where(mask, lnpi, -np.inf)
    want = np.asarray(JPar.sharded_normalize_2d(jmesh, lnpi_m, mask))
    single = TS2.normalize_2d(torch.as_tensor(lnpi_m), torch.as_tensor(mask)).numpy()
    for n in (8, 4):
        got = torch.cat(TPar.sharded_normalize_2d(tmesh(n), lnpi_m, mask)).numpy()
        assert np.abs(got[mask] - want[mask]).max() <= NORM_BAR and np.abs(got[mask] - single[mask]).max() <= NORM_BAR
        assert abs(np.sum(np.exp(got[mask])) - 1.0) < 1e-12


# ------------------------------------------------------- not divisible


def _raises_like_jax(jax_call, port_call):
    with pytest.raises(ValueError) as want:
        jax_call()
    with pytest.raises(ValueError) as got:
        port_call()
    assert str(got.value) == str(want.value)


def test_not_divisible_raises_as_jax(jmesh, n31, lnpi_state, long_lnpi):
    th, tm, jh, jm, mus, _ = n31
    mesh = tmesh(8)
    _raises_like_jax(lambda: JPar.shard_map_mu_sweep(jmesh, jh, jm, np.linspace(0, 1, 65)), lambda: TPar.shard_map_mu_sweep(mesh, th, tm, np.linspace(0, 1, 65)))
    th2, tm2, jh2, jm2 = lnpi_state
    _raises_like_jax(
        lambda: JPar.sharded_trace_coexistence(jmesh, jh2, jm2, np.linspace(0.97, 1.03, 7), 5.0),
        lambda: TPar.sharded_trace_coexistence(mesh, th2, tm2, np.linspace(0.97, 1.03, 7), 5.0),
    )
    x = jnp.asarray(long_lnpi[:1020])
    _raises_like_jax(lambda: JPar.sharded_normalize_long(jmesh, x), lambda: TPar.sharded_normalize_long(mesh, long_lnpi[:1020]))
    _raises_like_jax(lambda: JPar.sharded_stencil_flags(jmesh, x, 3), lambda: TPar.sharded_stencil_flags(mesh, long_lnpi[:1020], 3))
    _raises_like_jax(lambda: JPar.sharded_relextrema(jmesh, x, 3, 8), lambda: TPar.sharded_relextrema(mesh, long_lnpi[:1020], 3, 8))
    m2 = np.ones((12, 8), dtype=bool)
    _raises_like_jax(lambda: JPar.sharded_normalize_2d(jmesh, np.zeros((12, 8)), m2), lambda: TPar.sharded_normalize_2d(mesh, np.zeros((12, 8)), m2))
