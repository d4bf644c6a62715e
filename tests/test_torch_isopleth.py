"""PyTorch port: the binary isopleth path against the JAX package.

The port of tests/test_isopleth.py, tests/test_pallas_iso.py and
tests/test_fail_codes.py on synthetic sources (tests/torch_composites.py
iso_sources: the n31 or n1400 composite at reference dMu_2 -5 and -4, or
-5, -4.6 and -4.2, each with a small lnPI tilt) in place of the
reference's fixtures.  Each source is written to a .nc file once and
loaded by both packages' histogram classes.

The port's make_grid on CPU runs the plain version (binary.isopleth
iso_grid_body), which forms each side's lnPI' without the grand-canonical
averages (a constant over the bins; binary/isopleth.py says why).  It is
held against the JAX package's make_grid on its XLA engine with valid and
fail_code equal on every cell, Z and density to 1e-12 and F.E./kT to
1e-11 absolute at order 1, all three to 1e-10 at order 2.  Measured worst
when these bars were set: Z 7.2e-12 at N=1400 order 2 (the order-2 lnPI'
terms of ~1e3 round differently in the two packages' association, as in
tests/test_torch_mb.py), fe 3.4e-13; order 1 stays under 1e-14 on Z and
density and 1.2e-13 on fe (fe is of order 1e2 here).
"""

import sys

import numpy as np
import pytest
import torch

import fhmcanalysis_torch.core.cuda_iso as CI
from fhmcanalysis_torch.binary import check_gibbs_duhem, combine_isopleth_grids, get_iso, isopleth, parameterize_mesh
from fhmcanalysis_torch.binary.isopleth import (
    FAIL_EDGE_UNSAFE,
    FAIL_OK,
    FAIL_PHASE_OVERFLOW,
    FAIL_SEGMENTATION,
    _find_left_right,
    _get_most_stable_phase,
)
from fhmcanalysis_torch.histogram.ntot import histogram
from fhmcanalysis_torch.io import write_composite
from fhmcanalysis_torch.parallel import grid_mesh
from fhmcanalysis_tpu.binary import isopleth as jax_isopleth
from fhmcanalysis_tpu.histogram.ntot import histogram as jax_histogram
from torch_composites import ISO31, ISO1400, ISO_FIVE_DMU2, ISO_NARROW, iso_grid_args, iso_sources, port_histogram

IB = sys.modules["fhmcanalysis_torch.binary.isopleth"]
torch.set_num_threads(1)
TOL = 1.0e-9
GRID31 = iso_grid_args(ISO31, NX=16, NY=8)
GRID1400 = iso_grid_args(ISO1400, NX=16, NY=4)
NARROW = iso_grid_args(ISO_NARROW)
JANUS_GRID = ((4.9, 5.1), (-4.9, -4.1), (0.02, 0.1))
FAIL_GRID = ((4.9, 5.1), (-4.9, -4.1), (0.1, 0.4))
THREE = (-5.0, -4.6, -4.2)

_X31 = np.linspace(0.0, 1.0, 31)
# tests/test_pallas_iso.py:70-86: the first two peaks are each weaker than
# the last but jointly stronger, so janus flips the most stable phase
THREE_PEAK = 11.5 * np.exp(-((_X31 - 0.15) ** 2) / 0.004) + 11.3 * np.exp(-((_X31 - 0.45) ** 2) / 0.003) + 12 * np.exp(-((_X31 - 0.8) ** 2) / 0.006)
# tests/test_fail_codes.py:54-85
RISING = 0.1 * np.arange(31, dtype=float)
TEN_PEAK = 5.0 * np.sin(2 * np.pi * np.arange(31) / 3.1) - 0.01 * np.arange(31)
TEN_PEAK[-1] = TEN_PEAK.min() - 50.0
WALK = np.cumsum(np.random.default_rng(7).standard_normal(31)) * 2.0
WALK[-1] = WALK.min() - 50.0
SURFACES = {"three_peak": THREE_PEAK, "rising": RISING, "ten_peak": TEN_PEAK, "walk": WALK}


@pytest.fixture(scope="module")
def sources(tmp_path_factory):
    """sources(name, dmu2s, surface, smooth, used_ke, max_order) ->
    (port histograms, JAX histograms), fresh objects from files written
    once per configuration."""
    root = tmp_path_factory.mktemp("iso")
    files = {}

    def get(name="n31", dmu2s=(-5.0, -4.0), surface=None, smooth=None, used_ke=False, max_order=3):
        key = (name, dmu2s, surface, smooth, used_ke, max_order)
        if key not in files:
            ds, mk = iso_sources(name, dmu2s, max_order, used_ke, SURFACES.get(surface), smooth)
            paths = []
            for j, d in enumerate(ds):
                p = str(root / f"src{len(files)}_{j}.nc")
                write_composite(p, d["lnpi"], d["op"], d["mom"], d["volume"], mk["nspec"], mk["max_order"], history="synthetic composite")
                paths.append((p, d))
            files[key] = (paths, mk)
        paths, mk = files[key]
        port = [histogram(p, d["curr_beta"], d["curr_mu"], mk["smooth"], mk["used_ke"], device="cpu") for p, d in paths]
        ref = [jax_histogram(p, d["curr_beta"], d["curr_mu"], mk["smooth"], mk["used_ke"]) for p, d in paths]
        return port, ref

    return get


def _grids(port, ref, beta, order, grid, collect=None):
    a = isopleth(port, beta, order=order)
    a.make_grid(*grid, collect=collect)
    b = jax_isopleth(ref, beta, order=order)
    b.make_grid(*grid, collect=collect)
    return a, b


def _assert_parity(a, b, order, min_ok=0.3):
    np.testing.assert_array_equal(a.data["X"], b.data["X"])
    np.testing.assert_array_equal(a.data["Y"], b.data["Y"])
    np.testing.assert_array_equal(a.data["valid"], b.data["valid"])
    np.testing.assert_array_equal(a.data["fail_code"], b.data["fail_code"])
    np.testing.assert_array_equal(a.data["fail_code"] == FAIL_OK, a.data["valid"])
    ok = b.data["valid"].astype(bool)
    assert ok.mean() >= min_ok, "grid mostly invalid: the comparison would be vacuous"
    bars = {"Z": 1e-12, "density": 1e-12, "F.E./kT": 1e-11} if order == 1 else dict.fromkeys(("Z", "density", "F.E./kT"), 1e-10)
    for k, bar in bars.items():
        d = np.max(np.abs(np.where(ok, a.data[k] - b.data[k], 0.0)))
        assert d <= bar, (k, d)


CASES = [
    ("n31", 1, None, {}),
    ("n31", 2, None, {}),
    ("n31", 1, None, {"dmu2s": THREE}),
    ("n31", 2, None, {"dmu2s": THREE}),
    ("n31", 2, None, {"used_ke": True}),
    ("n1400", 1, None, {}),
    ("n1400", 2, None, {}),
]


@pytest.mark.parametrize("name,order,collect,kw", CASES)
def test_make_grid_matches_jax(sources, name, order, collect, kw):
    grid = GRID31 if name == "n31" else GRID1400
    beta = 1.02 if name == "n31" else 1.0  # N=1400: beta_target = beta_ref (ISO1400 says why)
    a, b = _grids(*sources(name, **kw), beta, order, grid, collect)
    _assert_parity(a, b, order)


@pytest.mark.parametrize("order", [1, 2])
def test_narrow_five_source_grid_matches_jax(sources, order):
    """Five sources on a narrow grid (torch_composites.ISO_NARROW: 12 mu_1
    columns, rows past the sources on both sides), the grid whose blocks
    stage several sources in K3 at one cell per lane: every source is
    bracketed, and the port matches the JAX package cell for cell."""
    a, b = _grids(*sources(dmu2s=ISO_FIVE_DMU2), ISO_NARROW["beta"], order, NARROW)
    _assert_parity(a, b, order)
    lr, _ = a._bracket(a.data["Y"][:, 0], 2.5)
    assert set(lr.ravel().tolist()) == set(range(len(ISO_FIVE_DMU2)))


@pytest.mark.parametrize("order", [1, 2])
def test_janus_collect_matches_jax(sources, order):
    """Three-peak sources: janus per cell in both packages, and it changes
    the surface against collect=None (tests/test_pallas_iso.py:89-111)."""
    a, b = _grids(*sources(surface="three_peak"), 1.001, order, JANUS_GRID, "janus")
    _assert_parity(a, b, order)
    c = isopleth(sources(surface="three_peak")[0], 1.001, order=order)
    c.make_grid(*JANUS_GRID)
    both = a.data["valid"] & c.data["valid"]
    assert np.max(np.abs(np.where(both, a.data["F.E./kT"] - c.data["F.E./kT"], 0.0))) > 1e-6


@pytest.mark.parametrize(
    "surface,smooth,code",
    [("rising", None, FAIL_EDGE_UNSAFE), ("ten_peak", None, FAIL_PHASE_OVERFLOW), ("walk", 4, FAIL_SEGMENTATION)],
)
def test_fail_codes_match_jax(sources, surface, smooth, code):
    """tests/test_fail_codes.py's surfaces give the same code in both
    packages, cell for cell: edge-unsafe everywhere on a rising lnPI, phase
    overflow on ~10 peaks, invalid segmentation on a smoothed random walk."""
    a, b = _grids(*sources(surface=surface, smooth=smooth), 1.001, 1, FAIL_GRID)
    _assert_parity(a, b, 1, min_ok=0.0)
    if surface == "rising":
        assert not a.data["valid"].any()
        np.testing.assert_array_equal(a.data["fail_code"], code)
    else:
        assert (a.data["fail_code"] == code).any(), np.unique(a.data["fail_code"])


def test_sources_with_their_own_op_grids(sources):
    """Each source is reweighted with its own order parameter, as in the
    JAX package's XLA engine (the TPU kernel refused differing op grids):
    source 1's op skips one value past its middle, in both packages (a
    uniform shift would change every cell by a constant only)."""
    port, ref = sources()
    for h in (port[1], ref[1]):
        h.data["ntot"] = h.data["ntot"] + (h.data["ntot"] >= 15)
    a, b = _grids(port, ref, 1.02, 1, GRID31)
    _assert_parity(a, b, 1)
    c = isopleth(sources()[0], 1.02, order=1)
    c.make_grid(*GRID31)
    assert np.max(np.abs(c.data["F.E./kT"] - a.data["F.E./kT"])) > 1e-6


def test_make_grid_matches_host_loop(sources):
    """The literal composition on the port's own class -- reweight ->
    temp_dmu_extrap -> mix -> thermo -> is_safe per cell
    (gc_binary.pyx:406-476, tests/test_isopleth.py:84-128) -- against the
    port's make_grid, whose cells drop the grand-canonical averages."""
    beta_t, m = 1.02, 2.5
    grid = iso_grid_args(ISO31, NX=6, NY=4)
    iso = isopleth(sources()[0], beta_t, order=1)
    Z, (X, Y) = iso.make_grid(*grid, m=m)
    assert np.count_nonzero(Z) > 0, "grid entirely failed; parity comparison would be vacuous"
    for i in range(X.shape[0]):
        for j in range(X.shape[1]):
            mu1, dmu2 = X[i, j], Y[i, j]
            left, right = _find_left_right(iso.data["dmu2"], dmu2, True)
            hs = sources()[0]
            try:
                h_l = hs[left]
                h_l.reweight(mu1)
                h_l = h_l.temp_dmu_extrap(beta_t, np.array([dmu2]), 1, 10.0, False, True, False)
                h_r = hs[right]
                h_r.reweight(mu1)
                h_r = h_r.temp_dmu_extrap(beta_t, np.array([dmu2]), 1, 10.0, False, True, False)
                dl = abs(iso.data["dmu2"][left] - dmu2) ** m
                dr = abs(iso.data["dmu2"][right] - dmu2) ** m
                w = [1.0, 1.0] if dl + dr < 1e-9 else [dr / (dr + dl), dl / (dr + dl)]
                h_m = h_l.mix(h_r, w)
                h_m.thermo()
                if not h_m.is_safe():
                    raise Exception("unsafe")
                p = _get_most_stable_phase(h_m)
                want = [h_m.data["thermo"][p][k] for k in ("x1", "density", "F.E./kT")]
            except Exception:
                want = [0.0, 0.0, 0.0]
            assert abs(Z[i, j] - want[0]) < 1e-8, (i, j, Z[i, j], want[0])
            assert abs(iso.data["density"][i, j] - want[1]) < 1e-8
            assert abs(iso.data["F.E./kT"][i, j] - want[2]) < 1e-6


def test_plain_chunks_agree(sources):
    """mu1_chunk only cuts the plain version into mu_1 blocks."""
    a = isopleth(sources()[0], 1.02, order=2)
    a.make_grid(*GRID31)
    b = isopleth(sources()[0], 1.02, order=2)
    b.make_grid(*GRID31, mu1_chunk=3)
    for k in ("Z", "density", "F.E./kT", "valid", "fail_code"):
        np.testing.assert_array_equal(a.data[k], b.data[k], err_msg=k)


def test_helper_built_sources_equal_file_sources(sources):
    """The file-free sources of chip_smoke.py (torch_composites
    port_histogram) give the file-loaded surface bit for bit."""
    ds, mk = iso_sources()
    a = isopleth([port_histogram(d, mk, device="cpu") for d in ds], 1.02, order=1)
    a.make_grid(*GRID31)
    b = isopleth(sources()[0], 1.02, order=1)
    b.make_grid(*GRID31)
    for k in ("Z", "density", "F.E./kT", "valid", "fail_code"):
        np.testing.assert_array_equal(a.data[k], b.data[k], err_msg=k)


def test_engines_on_the_cpu(sources):
    """A CPU histogram never reaches K3: engine='cuda' raises, the launch
    counter stays at 0, 'torch' equals 'auto', and so does a mesh of CPU
    devices (mesh=; tests/test_torch_parallel.py holds it against JAX)."""
    iso = isopleth(sources()[0], 1.02, order=1)
    with pytest.raises(ValueError, match="CUDA tensors"):
        iso.make_grid(*GRID31, engine="cuda")
    with pytest.raises(ValueError, match="CUDA tensors"):
        iso.make_grid(*GRID31, mesh=grid_mesh(2, devices=["cpu"] * 2), engine="cuda")
    with pytest.raises(ValueError, match="engine"):
        iso.make_grid(*GRID31, engine="xla")
    iso.make_grid(*GRID31, engine="auto")
    auto = {k: iso.data[k] for k in ("Z", "valid", "fail_code")}
    iso.make_grid(*GRID31, engine="torch")
    for k, v in auto.items():
        np.testing.assert_array_equal(v, iso.data[k], err_msg=k)
    iso.make_grid(*GRID31, mesh=grid_mesh(3, devices=["cpu"] * 3))
    for k, v in auto.items():
        np.testing.assert_array_equal(v, iso.data[k], err_msg=k)
    with pytest.raises(KeyError):
        iso.make_grid(*GRID31, collect="nope")
    assert CI.iso_grid.launches == 0


def test_make_grid_rejects_insufficient_max_order(sources):
    """order=2 moment extrapolation needs max_order >= 3 (fail fast, as in
    the JAX package)."""
    iso = isopleth(sources(max_order=2)[0], 1.02, order=2)
    with pytest.raises(Exception, match="Maximum order"):
        iso.make_grid(*GRID31)


def test_get_hist_matches_jax(sources):
    port, ref = sources()
    a = isopleth(port, 1.02, order=1).get_hist(-20.0, -4.5)
    b = jax_isopleth(ref, 1.02, order=1).get_hist(-20.0, -4.5)
    assert abs(a.data["curr_beta"] - 1.02) < 1e-12
    assert abs((a.data["curr_mu"][1] - a.data["curr_mu"][0]) - (-4.5)) < 1e-9
    np.testing.assert_allclose(a.data["ln(PI)"], b.data["ln(PI)"], rtol=0, atol=1e-12)
    np.testing.assert_allclose(a.data["mom"], b.data["mom"], rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(a.data["curr_mu"], b.data["curr_mu"])


def test_dump_load_zoom(sources, tmp_path):
    iso = isopleth(sources()[0], 1.02, order=1)
    iso.make_grid(*GRID31)
    fn = str(tmp_path / "surf.json")
    iso.dump(fn)
    iso2 = isopleth(sources()[0], 1.02, order=1)
    iso2.load(fn)
    for k in ("Z", "X", "Y", "density", "F.E./kT", "fail_code"):
        np.testing.assert_array_equal(iso2.data[k], iso.data[k], err_msg=k)
    ref = jax_isopleth(sources()[1], 1.02, order=1)
    ref.load(fn)
    np.testing.assert_array_equal(ref.data["Z"], iso.data["Z"])
    zz, (zx, zy), rho, fe = iso2.zoom(2.0, order=1)
    assert zz.shape[0] == iso.data["Z"].shape[0] * 2


class TestCombine:
    def test_fail_misaligned(self):
        mu1 = np.linspace(-15, -10, 10)
        dmu2 = np.linspace(-5, -3, 5)
        x1, y1 = np.meshgrid(mu1, dmu2)
        z1 = x1**2 + y1**2
        x2, y2 = np.meshgrid(np.linspace(-10, -5, 10), np.linspace(-5, -4, 5))
        z2 = x2**2 + y2**2
        with pytest.raises(Exception):
            combine_isopleth_grids([x2, x1], [y2, y1], [z2, z1])
        x2, y2 = np.meshgrid(np.linspace(-10, -5, 10), np.linspace(-5, -3, 6))
        z2 = x2**2 + y2**2
        with pytest.raises(Exception):
            combine_isopleth_grids([x2, x1], [y2, y1], [z2, z1])

    def test_pass(self):
        dmu2 = np.linspace(-5, -3, 5)
        x1, y1 = np.meshgrid(np.linspace(-15, -10, 10), dmu2)
        z1 = x1**2 + y1**2
        x2, y2 = np.meshgrid(np.linspace(-10, -5, 10), dmu2)
        z2 = x2**2 + y2**2
        x3, y3 = np.meshgrid(np.concatenate((np.linspace(-15, -10, 10), np.linspace(-10, -5, 10)[1:])), dmu2)
        z3 = x3**2 + y3**2
        Z, (X, Y) = combine_isopleth_grids([x2, x1], [y2, y1], [z2, z1])
        assert np.all(np.abs(X - x3) < TOL) and np.all(np.abs(Y - y3) < TOL) and np.all(np.abs(Z - z3) < TOL)
        Z, (X, Y), A, B = combine_isopleth_grids([x2, x1], [y2, y1], [z2, z1], [2 * z2, 2 * z1], [3 * z2, 3 * z1])
        assert np.all(np.abs(A - 2 * z3) < TOL) and np.all(np.abs(B - 3 * z3) < TOL)


class TestFindLeftRight:
    def test_brackets(self):
        arr = np.array([-5.0, -4.0, -2.0])
        assert _find_left_right(arr, -6.0, False) == (-1, -1)
        assert _find_left_right(arr, -6.0, True) == (0, 0)
        assert _find_left_right(arr, -1.0, False) == (3, 3)
        assert _find_left_right(arr, -1.0, True) == (2, 2)
        assert _find_left_right(arr, -4.0, False) == (1, 1)
        assert _find_left_right(arr, -3.0, False) == (1, 2)


class TestGetIso:
    def test_marching_squares_vs_matplotlib(self):
        x = np.linspace(-2, 2, 41)
        X, Y = np.meshgrid(x, x)
        Z = X**2 + Y**2
        pts = np.array(get_iso(1.0, Z, X, Y))
        r = np.sqrt(pts[:, 0] ** 2 + pts[:, 1] ** 2)
        assert np.all(np.abs(r - 1.0) < 0.01)
        ang = np.arctan2(pts[:, 1], pts[:, 0])
        assert ang.max() - ang.min() > 5.5

        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        cs = plt.contour(X, Y, Z, [1.0])
        v = max(cs.allsegs[0], key=len)
        rm = np.sqrt(v[:, 0] ** 2 + v[:, 1] ** 2)
        assert abs(np.mean(r) - np.mean(rm)) < 5e-3
        plt.close("all")

    def test_parameterize_mesh(self):
        x = np.linspace(0, 1, 11)
        X, Y = np.meshgrid(x, x)
        out = parameterize_mesh(X, Y, X + Y, X - Y, [(0.5, 0.5), (0.25, 0.75)])
        assert np.allclose(out[0], (1.0, 0.0))
        assert np.allclose(out[1], (1.0, -0.5))


class TestGibbsDuhem:
    def test_ideal_surface(self):
        """Ideal binary mixture: x1 dmu1/dx1 + (1-x1) dmu2/dx1 = 0 along
        isobars (tests/test_isopleth.py:193-217)."""
        MU1, DMU2 = np.meshgrid(np.linspace(-3.0, -1.0, 41), np.linspace(-1.0, 1.0, 41))
        Z1, Z2 = np.exp(MU1), np.exp(MU1 + DMU2)
        res = check_gibbs_duhem(np.array([0.3]), Z1 / (Z1 + Z2), Z1 + Z2, MU1, DMU2)
        p, errs, x1s, mus, q1s = res[0]
        errs = np.asarray(errs)
        assert len(errs) > 10
        assert np.median(np.abs(errs)) < 1e-2
        assert np.max(np.abs(errs)) < 1e-1
