"""The port's native table reader (native/fast_table.cpp) against the JAX
package's and against np.loadtxt.

Window files come from tests/torch_windows.py: every numeric table the
front-ends read (FHMCSimulation lnPI / moments, checkpoint dumps, FEASST
colMat / extMom_pr) parsed by the port's native reader, the port's numpy
fallback and the JAX package's reader must give the same array, bit for
bit, and the same shape (a single column comes back 1-D unpacked).
"""

import glob
import os

import numpy as np
import pytest
import torch_windows as TW

import fhmcanalysis_torch.native as PN
import fhmcanalysis_tpu.native as JN
from fhmcanalysis_torch.win_patch import windows as W


@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    """Every numeric table of a small tree in each format."""
    root = str(tmp_path_factory.mktemp("native"))
    src = TW.ntot_source(81, seed=5)
    bounds = W.ntot_window_scaling(80, 20, 7, 6)
    TW.write_fhmc(os.path.join(root, "fhmc"), src, bounds, seed=1, mom_noise=1e-3)
    TW.write_fhmc(os.path.join(root, "cp"), src, bounds, seed=2, checkpoints=[(1, 2)] * len(bounds))
    TW.write_chkpt(os.path.join(root, "chkpt"), src, bounds, seed=3)
    TW.write_feasst(os.path.join(root, "feasst"), src, bounds, seed=4)
    TW.write_feasst(os.path.join(root, "mc"), src, bounds, seed=4, multicore=True)
    names = ("*lnPI.dat", "*extMom*.dat", "colMat*", "extMom_pr*")
    files = sorted({f for n in names for f in glob.glob(os.path.join(root, "**", n), recursive=True)})
    assert len(files) == 2 * 2 * 7 + 2 * 7 + 2 * 7 + 2 * 8 + 2 * 7
    return files


def _numpy_only(fn, *args):
    """fn(*args) with the port's native reader switched off."""
    saved = PN._cache.get("_fhmc_native")
    PN._cache["_fhmc_native"] = False
    try:
        return fn(*args)
    finally:
        if saved is None:
            PN._cache.pop("_fhmc_native")
        else:
            PN._cache["_fhmc_native"] = saved


def _same(a, b):
    return a.shape == b.shape and a.dtype == b.dtype and np.array_equal(a, b)


def test_native_built():
    """g++ is present here: the port's reader must build (its own hashed
    build into fhmcanalysis_torch/_build/)."""
    assert PN.NATIVE_AVAILABLE
    assert any(p.name.startswith("_fhmc_native_") for p in PN.BUILD_DIR.iterdir())


@pytest.mark.parametrize("kind", ["read_table", "loadtxt_unpacked"])
def test_tree_tables_match(tables, kind):
    for fn in tables:
        got = getattr(PN, kind)(fn)
        want = getattr(JN, kind)(fn)
        plain = _numpy_only(getattr(PN, kind), fn)
        ref = np.loadtxt(fn, ndmin=2) if kind == "read_table" else np.loadtxt(fn, unpack=True)
        assert _same(got, want) and _same(got, plain) and _same(got, ref), fn


def test_single_column_is_1d(tmp_path):
    fn = str(tmp_path / "one.dat")
    with open(fn, "w") as f:
        f.write("# lnPI\n0.5\n-1.25e-3\n7\n")
    for out in (PN.loadtxt_unpacked(fn), _numpy_only(PN.loadtxt_unpacked, fn), JN.loadtxt_unpacked(fn)):
        assert out.ndim == 1 and np.array_equal(out, np.loadtxt(fn, unpack=True))
    assert PN.read_table(fn).shape == (3, 1)


def test_scientific_negative_and_comments(tmp_path):
    fn = str(tmp_path / "sci.dat")
    with open(fn, "w") as f:
        f.write("# header\n-1.5e-300\t2E+10\t0.0\n\n  # indented comment\n3 -4 7.25\r\n1.7976931348623157e308 -0 5e-324\n")
    want = np.array([[-1.5e-300, 2e10, 0.0], [3.0, -4.0, 7.25], [1.7976931348623157e308, -0.0, 5e-324]])
    for out in (PN.read_table(fn), _numpy_only(PN.read_table, fn), JN.read_table(fn)):
        assert _same(out, want)
        assert np.array_equal(np.signbit(out), np.signbit(want))
    # a comment character of the caller's choosing
    fn2 = str(tmp_path / "pct.dat")
    with open(fn2, "w") as f:
        f.write("% header\n1 2\n")
    assert _same(PN.read_table(fn2, comment="%"), JN.read_table(fn2, comment="%"))


@pytest.mark.parametrize(
    "body", ["1 2 3\n4 5\n", "1 2\n3 abc\n", "1 2\n3 4x\n"], ids=["ragged", "non-numeric", "trailing-junk"]
)
@pytest.mark.parametrize("parser", ["native", "numpy", "jax"])
def test_rejected(tmp_path, body, parser):
    fn = str(tmp_path / "bad.dat")
    with open(fn, "w") as f:
        f.write(body)
    with pytest.raises(ValueError):
        if parser == "native":
            PN.read_table(fn)
        elif parser == "numpy":
            _numpy_only(PN.read_table, fn)
        else:
            JN.read_table(fn)


def test_missing_file_raises(tmp_path):
    with pytest.raises(OSError):
        PN.read_table(str(tmp_path / "absent.dat"))


def test_cold_build_from_threads(tmp_path, monkeypatch):
    """The host flood's threads reach the loader together on a cold build
    directory: every one gets the module, built once (before the lock, the
    second thread's rename found the first's temporary file gone and the
    loader cached the failure)."""
    import threading

    monkeypatch.setattr(PN, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(PN, "_cache", {})
    got = []

    def load():
        try:
            got.append(PN._load("imaging.cpp", "_fhmc_imaging") is not False)
        except Exception as e:  # noqa: BLE001 - the failure is the finding
            got.append(type(e).__name__)

    threads = [threading.Thread(target=load) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    assert got == [True] * 8
    assert len(list(tmp_path.glob("_fhmc_imaging_*.so"))) == 1 and not list(tmp_path.glob("*.tmp"))
