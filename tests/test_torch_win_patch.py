"""PyTorch port: win_patch (window patching and equilibration) against the
JAX package's.

Window trees are written by tests/torch_windows.py (FHMCSimulation final
and checkpoint-named files over N_tot and N_1, checkpoint dumps, FEASST
per directory and per processor), each cut from a known composite.  Both
packages patch the same tree, each into its own directory:

* the composites (``read_composite`` of both files, and the in-memory
  route the card's machine takes, ``torch_windows.patch_in_memory`` ->
  ``to_composite()``) are bit-identical, dtypes included, apart from the
  timestamped history line;
* patch.log and maxEq are the same text; the worst (window, error) and
  every equilibration result are equal;
* the same exceptions, with the same messages, are raised.

The modules whose functions are named test_* are imported under aliases
so that pytest does not collect them.
"""

import os

import numpy as np
import pytest
import torch
import torch_composites as TC
import torch_windows as TW

import fhmcanalysis_torch.io as PIO
import fhmcanalysis_torch.win_patch.chkpt_equil as pCE
import fhmcanalysis_torch.win_patch.chkpt_patch as pCP
import fhmcanalysis_torch.win_patch.feasst_equil as pFE
import fhmcanalysis_torch.win_patch.feasst_patch as pFP
import fhmcanalysis_torch.win_patch.fhmc_equil as pE
import fhmcanalysis_torch.win_patch.fhmc_patch as pP
import fhmcanalysis_torch.win_patch.windows as pW
import fhmcanalysis_tpu.io as JIO
import fhmcanalysis_tpu.win_patch.chkpt_equil as jCE
import fhmcanalysis_tpu.win_patch.chkpt_patch as jCP
import fhmcanalysis_tpu.win_patch.feasst_equil as jFE
import fhmcanalysis_tpu.win_patch.feasst_patch as jFP
import fhmcanalysis_tpu.win_patch.fhmc_equil as jE
import fhmcanalysis_tpu.win_patch.fhmc_patch as jP
import fhmcanalysis_tpu.win_patch.windows as jW

torch.set_num_threads(1)

SMALL = (80, 20, 7, 6)  # ntot_window_scaling: 7 windows over N_tot 0-80, 6-bin overlaps
N1 = (50, 4, 5)  # n1_window_scaling: 5 windows over N_1 0-50 (the last a trailing one)
CHECKPOINTS = [(1, 2, 3), (2, 9, 10), (4,), (1, 5), (3,), (1, 2), (7, 8)]  # per window; 10 sorts after 9
NOISE = dict(noise={3: 0.05}, mom_noise=0.01)  # lnPI noise on window 4 trips tol; moments spread

FRONTS = {  # front-end -> (port patch module, JAX patch module)
    "fhmc": (pP, jP),
    "chkpt": (pCP, jCP),
    "feasst": (pFP, jFP),
}


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """name -> (front-end, tree root, source composite, get_patch_sequence kwargs)."""
    root = str(tmp_path_factory.mktemp("trees"))
    src = TW.ntot_source(81, seed=7)
    small = pW.ntot_window_scaling(*SMALL)
    out = {}

    def add(name, front, writer, source, bounds, seed, **kw):
        d = os.path.join(root, name)
        writer(d, source, bounds, seed=seed, **kw)
        out[name] = (front, d, source)

    add("fhmc", "fhmc", TW.write_fhmc, src, small, 1)
    add("fhmc_cp", "fhmc", TW.write_fhmc, src, small, 2, checkpoints=CHECKPOINTS)
    add("fhmc_n1", "fhmc", TW.write_fhmc, TW.n1_source(51, seed=3), pW.n1_window_scaling(*N1), 3, op_name="N_{1}")
    add("fhmc_noise", "fhmc", TW.write_fhmc, src, small, 4, checkpoints=CHECKPOINTS, **NOISE)
    add("chkpt", "chkpt", TW.write_chkpt, src, small, 5)
    add("chkpt_noise", "chkpt", TW.write_chkpt, src, small, 6, **NOISE)
    add("feasst", "feasst", TW.write_feasst, src, small, 7)
    add("feasst_mc", "feasst", TW.write_feasst, src, small, 8, multicore=True)
    add("feasst_noise", "feasst", TW.write_feasst, src, small, 9, **NOISE)
    c = TW.WIN800
    add("win800", "fhmc", TW.write_fhmc, TW.ntot_source(c["N"], seed=c["seed"], beta=c["beta"], mu0=c["mu0"]),
        pW.ntot_window_scaling(*c["windows"]), c["seed"])
    return out


def sequence(trees, name, mod=None):
    """The tree's patch sequence by ``mod`` (default: the port's front-end)."""
    front, d, _ = trees[name]
    mod = mod or FRONTS[front][0]
    return mod.get_patch_sequence_multicore(d) if name == "feasst_mc" else mod.get_patch_sequence(d)


def patch_file(mod, seq, out_dir, offset, smooth, tol=np.inf, skip_hist=False):
    """patch_all_windows of either package into out_dir: (return value,
    composite path, log path)."""
    os.makedirs(out_dir, exist_ok=True)
    out, log = os.path.join(out_dir, "composite.nc"), os.path.join(out_dir, "patch.log")
    if mod in (pP, jP):
        ret = mod.patch_all_windows(seq, out, log, offset, smooth, tol, skip_hist)
    elif mod in (pCP, jCP):
        ret = mod.patch_all_windows(seq, out_fname=out, log_fname=log, offset=offset, smooth=smooth, tol=tol, skip_hist=skip_hist)
    else:
        ret = mod.patch_all_windows(seq, out_fname=out, log_fname=log, offset=offset, smooth=smooth, tol=tol)
    return ret, out, log


def assert_same_composite(a, b, where):
    """Every key but history bit-identical, dtypes included."""
    assert set(a) == set(b), (where, set(a) ^ set(b))
    for k in a:
        if k == "history":
            assert a[k].startswith("Created ") and b[k].startswith("Created "), where
        elif isinstance(a[k], dict):
            assert_same_composite(a[k], b[k], f"{where}[{k}]")
        elif isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape and np.array_equal(a[k], b[k]), (where, k)
        else:
            assert type(a[k]) is type(b[k]) and a[k] == b[k], (where, k, a[k], b[k])


def raised(fn, *args, **kw):
    """(exception type, message) that fn raises, or None."""
    try:
        fn(*args, **kw)
    except Exception as e:  # noqa: BLE001 - the comparison is the point
        return type(e), str(e)
    return None


# ---------------------------------------------------------------------------
# windows.py


@pytest.mark.parametrize("fn", ["n1_window_scaling", "ntot_window_scaling"])
def test_window_scaling_grid(fn):
    """Every argument of a grid: the same bounds, or the same assertion."""
    grid = [(n, w, o) for n in (20, 50, 100, 800) for w in (2, 4, 7, 20) for o in (0, 1, 3, 5, 9)]
    if fn == "ntot_window_scaling":
        grid = [(n, dw, w, o) for n, w, o in grid for dw in (10, 25)]
    for args in grid:
        with np.errstate(all="ignore"):  # both warn alike where the power law degenerates
            a, b = raised(getattr(pW, fn), *args), raised(getattr(jW, fn), *args)
        assert a == b, args
        if a is None:
            with np.errstate(all="ignore"):
                assert getattr(pW, fn)(*args) == getattr(jW, fn)(*args), args


def test_production_window_set():
    """The chip phase's windows: 20, 25-183 bins, 5-bin overlaps."""
    b = pW.ntot_window_scaling(*TW.WIN800["windows"])
    assert b == jW.ntot_window_scaling(*TW.WIN800["windows"])
    assert len(b) == 20 and b[0][0] == 0 and b[-1][1] == 800
    assert min(u - l for l, u in b) == 24 and max(u - l for l, u in b) == 182
    assert all(u0 - l1 + 1 == 5 for (_, u0), (l1, _) in zip(b, b[1:]))


# ---------------------------------------------------------------------------
# discovery


@pytest.mark.parametrize(
    "name, kw",
    [
        ("fhmc", {}),
        ("fhmc", {"bound": 4}),
        ("fhmc_cp", {}),
        ("fhmc_cp", {"cP": 2}),
        ("fhmc_cp", {"cP": 1}),
        ("fhmc_cp", {"min_cp": 4}),
        ("fhmc_cp", {"min_cp": 3, "bound": 5}),
        ("chkpt", {}),
        ("chkpt", {"bound": 3}),
        ("feasst", {}),
        ("feasst", {"bound": 2}),
    ],
)
def test_patch_sequence(trees, name, kw):
    front, d, _ = trees[name]
    p, j = FRONTS[front]
    got, want = p.get_patch_sequence(d, **kw), j.get_patch_sequence(d, **kw)
    assert got == want
    if name == "fhmc_cp" and not kw:  # the highest checkpoint of each window, natural order
        assert [s[0].rsplit("/", 1)[1] for s in got] == ["tmmc-Checkpoint-%d_lnPI.dat" % max(c) for c in CHECKPOINTS]
    if name == "chkpt" and not kw:  # the last window has not crossed over
        assert len(got) == 6


def test_multicore_sequence(trees, tmp_path):
    d = trees["feasst_mc"][1]
    assert pFP.get_patch_sequence_multicore(d) == jFP.get_patch_sequence_multicore(d)
    assert len(pFP.get_patch_sequence_multicore(d)) == 7  # the eighth processor is dropped
    empty = str(tmp_path)
    assert raised(pFP.get_patch_sequence_multicore, empty) == raised(jFP.get_patch_sequence_multicore, empty) is not None


# ---------------------------------------------------------------------------
# the patch


PATCH_CASES = [
    ("fhmc", dict(offset=2, smooth=False)),
    ("fhmc", dict(offset=2, smooth=True)),
    ("fhmc", dict(offset=1, smooth=True, skip_hist=True)),
    ("fhmc_cp", dict(offset=2, smooth=True)),
    ("fhmc_n1", dict(offset=2, smooth=False)),
    ("fhmc_n1", dict(offset=1, smooth=True, skip_hist=True)),
    ("fhmc_noise", dict(offset=2, smooth=False, tol=1e-4)),
    ("fhmc_noise", dict(offset=1, smooth=True, tol=1e-4, skip_hist=True)),
    ("chkpt", dict(offset=2, smooth=False)),
    ("chkpt", dict(offset=1, smooth=True, skip_hist=True)),
    ("chkpt_noise", dict(offset=2, smooth=True, tol=1e-4)),
    ("feasst", dict(offset=2, smooth=False)),
    ("feasst", dict(offset=0, smooth=True)),
    ("feasst_mc", dict(offset=1, smooth=True)),
    ("feasst_noise", dict(offset=2, smooth=False, tol=1e-4)),
    ("win800", dict(offset=1, smooth=False)),
    ("win800", dict(offset=1, smooth=True)),
]


@pytest.mark.parametrize("name, kw", PATCH_CASES, ids=[f"{n}-" + "-".join(f"{k}={v}" for k, v in kw.items()) for n, kw in PATCH_CASES])
def test_patch_matches_jax(trees, tmp_path, name, kw):
    front, _, source = trees[name]
    p, j = FRONTS[front]
    seq = sequence(trees, name)
    assert seq == sequence(trees, name, j)
    ret_p, nc_p, log_p = patch_file(p, seq, str(tmp_path / "port"), **kw)
    ret_j, nc_j, log_j = patch_file(j, seq, str(tmp_path / "jax"), **kw)
    assert ret_p == ret_j  # the worst (window, error), bit for bit
    with open(log_p) as a, open(log_j) as b:
        text = a.read()
        assert text == b.read()
    if "tol" in kw:  # the noisy window trips the tolerance: a re-patch ran
        assert "tolerance exceeded" in text

    op_name = "N_{1}" if name == "fhmc_n1" else "N_{tot}"
    got, want = PIO.read_composite(nc_p, op_name), JIO.read_composite(nc_j, op_name)
    assert_same_composite(got, want, name)
    # the route of the card's machine: no file, the same composite
    mem, worst, err = TW.patch_in_memory(p, seq, kw["offset"], kw["smooth"], kw.get("skip_hist", False))
    assert_same_composite(mem, got, name + " in memory")
    assert (worst, err) == ret_p

    # the composite is the source over the windows patched: lnPI
    # normalized, moments exact up to the smoothing blend's rounding (the
    # noisy trees are not the source)
    if "noise" not in name:
        op = got["op"]
        assert op[0] == 0 and np.array_equal(op, np.arange(op[-1] + 1))
        lnpi = source["lnpi"][op] - TW.logsumexp(source["lnpi"][op])
        assert np.abs(got["lnpi"] - lnpi).max() <= 1e-10
        mom = source["mom"][..., op]
        scale = np.where(mom == 0.0, 1.0, np.abs(mom))
        assert (np.abs(got["mom"] - mom) / scale).max() <= (1e-12 if kw["smooth"] else 0.0)


def test_production_offset_2_raises(trees):
    """At the production 5-bin overlaps offset 2 keeps one overlap bin:
    both packages refuse the pair (fhmc_patch.py:435)."""
    seq = sequence(trees, "win800")
    got = raised(TW.patch_in_memory, pP, seq, 2, False)
    want = raised(TW.patch_in_memory, jP, seq, 2, False)
    assert got == want and got[0] is AssertionError and "no overlap" in got[1]


def test_merge_side_effects_match(trees):
    """window.merge under skip_hist fills the other window's own rows with
    ones (fhmc_patch.py:159, 165): the same in-place change in both."""
    seq = sequence(trees, "fhmc")
    for skip_hist in (False, True):
        pair = []
        for mod in (pP, jP):
            lo, hi = mod.window(*seq[2], 2, True), mod.window(*seq[3], 2, True)
            shift = hi.merge(lo, skip_hist)
            pair.append((shift, lo, hi))
        (sp, lp, hp), (sj, lj, hj) = pair
        assert sp == sj
        for a, b in ((lp, lj), (hp, hj)):
            assert np.array_equal(a.lnPI, b.lnPI) and np.array_equal(a.mom, b.mom)
            for x, y in zip([a.e_hist] + a.pk_hist, [b.e_hist] + b.pk_hist):
                assert len(x.h) == len(y.h) and all(np.array_equal(r, s) for r, s in zip(x.h, y.h))
                assert np.array_equal(x.lb, y.lb) and np.array_equal(x.ub, y.ub) and np.array_equal(x.bw, y.bw)
        ones = [np.all(r == 1.0) for r in lp.pk_hist[0].h]
        assert any(ones) == skip_hist


def _bad_tree(root, bounds, **kw):
    TW.write_fhmc(root, TW.ntot_source(61, seed=11), bounds, seed=11, **kw)
    return pP.get_patch_sequence(root)


@pytest.mark.parametrize("case", ["no-overlap", "triple-overlap", "out-of-order", "feasst-order-param", "chkpt-no-state"])
def test_patch_raises_alike(tmp_path, case):
    root = str(tmp_path / case)
    if case == "no-overlap":
        seq, mods = _bad_tree(root, [(0, 20), (21, 40), (35, 60)]), (pP, jP)
    elif case == "triple-overlap":
        seq, mods = _bad_tree(root, [(0, 20), (10, 30), (15, 40), (35, 60)]), (pP, jP)
    elif case == "out-of-order":  # n1_window_scaling's trailing window ends below its neighbour
        TW.write_fhmc(root, TW.n1_source(42, seed=2), pW.n1_window_scaling(40, 4, 5), seed=2, op_name="N_{1}")
        seq, mods = pP.get_patch_sequence(root), (pP, jP)
    elif case == "feasst-order-param":
        TW.write_feasst(root, TW.ntot_source(61, seed=12), [(0, 30), (25, 60)], order_param="pairs")
        seq, mods = pFP.get_patch_sequence(root), (pFP, jFP)
        for mod in (pFP, jFP):  # the window itself asserts
            assert raised(mod.window, *seq[0])[0] is AssertionError
    else:
        TW.write_chkpt(root, TW.ntot_source(61, seed=13), [(0, 30), (25, 60)])
        os.remove(os.path.join(root, "1", "checkpt", "state.json"))
        got, want = raised(pCP.get_patch_sequence, root), raised(jCP.get_patch_sequence, root)
        assert got == want and "Checkpoint status file" in got[1]
        return
    got = raised(patch_file, mods[0], seq, str(tmp_path / "port"), 2, False)
    want = raised(patch_file, mods[1], seq, str(tmp_path / "jax"), 2, False)
    assert got is not None and got == want, (got, want)


# ---------------------------------------------------------------------------
# equilibration


def _maxeq(mod, seq, per_err, path, trust, **kw):
    """(safe sequence or the exception, maxEq text)."""
    try:
        res = mod.test_nebr_equil(seq, per_err, path, trust=trust, **kw)
    except Exception as e:  # noqa: BLE001
        res = (type(e), str(e))
    with open(path) as f:
        return res, f.read()


@pytest.mark.parametrize("name", ["fhmc", "fhmc_cp", "fhmc_noise", "chkpt_noise", "feasst_noise", "win800"])
def test_equilibration_matches_jax(trees, tmp_path, name):
    front = trees[name][0]
    p, j = {"fhmc": (pE, jE), "chkpt": (pCE, jCE), "feasst": (pFE, jFE)}[front]
    match = "test_nebr_match" if front == "fhmc" else "test_nebr_match_"
    seq = sequence(trees, name)
    for a, b in zip(seq, seq[1:]):  # every neighbour pair, bit for bit
        assert getattr(p, match)(a, b, 2.0) == getattr(j, match)(a, b, 2.0)
    assert raised(getattr(p, match), seq[1], seq[0]) == raised(getattr(j, match), seq[1], seq[0]) is not None
    results = set()
    for per_err in (0.5, 1.5, 3.0, 100.0):
        for trust in (False, True):
            got = _maxeq(p, seq, per_err, str(tmp_path / "p_maxEq"), trust)
            want = _maxeq(j, seq, per_err, str(tmp_path / "j_maxEq"), trust)
            assert got == want, (per_err, trust)
            results.add(len(got[0]) if isinstance(got[0], list) else -1)
    if "noise" in name:  # the spread reaches each outcome: none safe, some, all
        assert {-1, len(seq)} < results, results
    else:
        assert results == {len(seq) - 1, len(seq)}  # trust adds the last window
    if front == "feasst":  # its own default bar, 3 percent
        assert pFE.test_nebr_equil(seq, fname="None") == jFE.test_nebr_equil(seq, fname="None")


def test_window_match_and_find_windows(trees):
    root = trees["fhmc_cp"][1]
    for w1, w2, per_err, min_cp in ((1, 2, 1.0, -1), (3, 4, 0.1, 1), (6, 7, 1.0, 1)):
        args = (os.path.join(root, str(w1)), os.path.join(root, str(w2)), per_err, min_cp)
        assert pE.test_window_match(*args) == jE.test_window_match(*args)
    bad = (os.path.join(root, "1"), os.path.join(root, "3"), 1.0, 5)  # window 3 has checkpoint 4 only
    assert raised(pE.test_window_match, *bad) == raised(jE.test_window_match, *bad) is not None
    got, want = pE.find_windows(root), jE.find_windows(root + "/")
    assert np.array_equal(got[0], want[0]) and got[1] == want[1] == [(k, k + 1) for k in range(1, 7)]
    final = trees["fhmc"][1]  # no checkpoint files: both fail alike
    assert raised(pE.find_windows, final) == raised(jE.find_windows, final) is not None


# ---------------------------------------------------------------------------
# the slice: windows -> composite -> the mu sweep


@pytest.mark.parametrize("name", ["fhmc", "win800"])
def test_patched_composite_sweeps_like_jax(trees, tmp_path, name):
    """The port's in-memory composite through histogram.from_composite and
    pipeline.mu_sweep_thermo (the plain version of K1 on the CPU) against
    the JAX class on the JAX package's file and its XLA sweep:
    segmentation equal, floats on real phases within 1e-12 relative to
    max(1, |value|) (<U> reaches ~1,300 at N_tot = 800, where 1e-12
    absolute is a few ulp)."""
    from fhmcanalysis_torch.core import pipeline as TP
    from fhmcanalysis_torch.histogram.ntot import histogram as PH
    from fhmcanalysis_tpu.core import pipeline as JP
    from fhmcanalysis_tpu.histogram.ntot import histogram as JH

    c = TW.WIN800 if name == "win800" else dict(N=81, beta=1.0, mu0=(5.0, 0.0), smooth=2, max_phases=4)
    seq = sequence(trees, name)
    mem, _, _ = TW.patch_in_memory(pP, seq, 1, True)
    _, nc, _ = patch_file(jP, seq, str(tmp_path), 1, True)
    hp = PH.from_composite(mem, c["beta"], list(c["mu0"]), smooth=c["smooth"], device="cpu")
    hj = JH(nc, c["beta"], list(c["mu0"]), c["smooth"])
    mus = np.linspace(*TC.mu_window(**c), 48)
    got = TP.mu_sweep_thermo(hp._hist(), hp._meta(max_phases=c["max_phases"]), mus, props=True)
    want = JP.mu_sweep_thermo(hj._hist(), hj._meta(max_phases=c["max_phases"]), mus, props=True, engine="xla")
    for k in ("valid", "mask", "n_phases", "left", "right"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    assert set(got["n_phases"].tolist()) == {1, 2}  # the window crosses from one phase to two
    ok = np.asarray(want["mask"])
    for k in ("fe", "n_i", "x_i", "ntot", "u", "density"):
        w = np.asarray(want[k])
        scale = np.where(np.isfinite(w), np.maximum(1.0, np.abs(w)), 1.0)
        assert TC.worst_abs_diff(got[k].numpy() / scale, w / scale, ok) <= 1e-12, k


def test_n1_composite_loads(trees):
    """An N_1 composite enters the port's n1 class from memory."""
    from fhmcanalysis_torch.histogram.n1 import histogram as PH1

    mem, _, _ = TW.patch_in_memory(pP, sequence(trees, "fhmc_n1"), 2, False)
    h = PH1.from_composite(mem, 1.0, [0.5, -0.5], smooth=1, device="cpu")
    np.testing.assert_array_equal(h.data["n1"], np.arange(51))
    assert abs(np.exp(h.data["ln(PI)"]).sum() - 1.0) < 1e-12
