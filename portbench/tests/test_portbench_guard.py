"""Nothing the benchmark runs loads JAX or the JAX package, and the plain
reference loads nothing of the program either."""

import subprocess
import sys

from portbench import harness

REFERENCE = ("compare", "derivs", "moments", "segment", "state", "sweeps")


def _loaded(code: str) -> list:
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300, cwd=harness.REPO)
    assert out.returncode == 0, out.stderr
    return out.stdout.split()


def test_reference_imports_neither_jax_nor_the_program():
    code = ("import sys; sys.path.insert(0, '.'); "
            + "; ".join(f"import portbench.reference.{m}" for m in REFERENCE)
            + "; print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))")
    top = set(_loaded(code))
    assert not top & {"jax", "jaxlib", "flax", "fhmcanalysis_tpu", "fhmcanalysis_torch"}, top


def test_a_cpu_run_loads_no_jax():
    """A whole run of a cell (the program on the CPU) leaves the harness's
    own guard empty; fhmcanalysis_torch is not fhmcanalysis_tpu."""
    code = ("import sys, time; sys.path.insert(0, '.'); sys.path.insert(0, 'portbench/tests'); from conftest import BENCH, SMALL; "
            "from portbench import harness; "
            "r = harness.run('bin31.mbsweep', 5, 0.2, False, time.perf_counter(), device='cpu', overrides=SMALL['bin31.mbsweep'], bench=BENCH); "
            "assert 'fhmcanalysis_torch' in sys.modules; print(' '.join(harness.loaded_forbidden()) or 'none')")
    assert _loaded(code) == ["none"]


def test_guard_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "fhmcanalysis_tpux", sys)
    monkeypatch.setitem(sys.modules, "jaxfoo.bar", sys)
    assert harness.loaded_forbidden() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert harness.loaded_forbidden() == ["jax"]
