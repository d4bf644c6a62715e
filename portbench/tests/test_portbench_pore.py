"""The cell pore96.states on the CPU at small sizes (its own, below): it
resolves by name, a sound run is correct, a run whose sweep alters one
free energy or leaves half its states out is not, the float32 control is
not, and its reference and inputs load neither JAX nor the program.  Its
readers of the program's spans and counters against hand counts."""

import subprocess
import sys
import time
import types

import numpy as np
import pytest
import torch
from conftest import BENCH

from portbench import control, harness

NAME = "pore96.states"
# 24 x 97 surfaces, a 4 x 4 grid; grid 2 puts each of its 4 states in a
# quarter of its own, so that the check samples every state
SMALL = {"H": 24, "N": 97, "grid": 4, "trace_calls": 2}
EVERY = dict(SMALL, grid=2)
SEED = 2**33 + 29


def run(over=SMALL):
    return harness.run(NAME, SEED, 0.3, False, time.perf_counter(), device="cpu", overrides=over, bench=BENCH)


def test_cell_resolves_by_name():
    cell = harness.Cell(NAME, BENCH)
    assert cell.wl["entry"] == "pore_sweep" and cell.cfg["name"] == "pore96" and cell.spec["chips"] == 1
    assert {m["name"] for m in cell.layer} == {"device_idle_pct.kernel_bound", "program_idle_pct.kernel_bound", "setup_import_s", "sweep2d_host_ms", "sweep2d_host_syncs"}
    assert {m["name"] for m in cell.e2e} >= {"setup_s"} and len(cell.e2e) == 2
    assert (cell.cfg["H"], cell.cfg["N"], cell.wl["grid"] ** 2) == (96, 385, 1024)


def test_sound_run_is_correct():
    r = run()
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] == 16 * r["calls"]


def test_altered_fe_is_not_correct(monkeypatch):
    from fhmcanalysis_torch import two_dim

    sweep = two_dim.pore_state_sweep

    def altered(*a, **k):
        out = sweep(*a, **k)
        out["fe"][0, 0] = out["fe"][0, 0] * (1 + 1e-6) + 1e-6
        return out

    monkeypatch.setattr(two_dim, "pore_state_sweep", altered)
    assert not run(EVERY)["correct"]


def test_half_left_out_is_not_correct(monkeypatch):
    """A sweep that computes the first half of its states and repeats it for
    the rest: the check's states in the grid's upper half read wrong."""
    from fhmcanalysis_torch import two_dim

    sweep = two_dim.pore_state_sweep

    def half(jh, fh, p_vals, beta_vals, *a, **k):
        S, n = len(p_vals), len(p_vals) // 2
        out = sweep(jh, fh, p_vals[:n], beta_vals[:n], *a, **k)
        rep = lambda v: v + v[: S - n] if isinstance(v, list) else (torch.cat if torch.is_tensor(v) else np.concatenate)([v, v[: S - n]])  # noqa: E731
        return {key: v if key == "prop_names" else rep(v) for key, v in out.items()}

    monkeypatch.setattr(two_dim, "pore_state_sweep", half)
    assert not run()["correct"]


def test_float32_control_is_not_correct():
    over = dict(SMALL, check_calls=1)
    assert control.readings(NAME, SEED, "program", "cpu", over, BENCH)["correct"]
    assert not control.readings(NAME, SEED, "control", "cpu", over, BENCH)["correct"]


def test_reference_and_inputs_import_neither_jax_nor_the_program():
    code = ("import sys; sys.path.insert(0, '.'); import portbench.reference.pore, portbench.inputs_pore; "
            "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300, cwd=harness.REPO)
    assert out.returncode == 0, out.stderr
    assert not set(out.stdout.split()) & {"jax", "jaxlib", "flax", "fhmcanalysis_tpu", "fhmcanalysis_torch"}


def _trace(host):
    """A window of 0-1000 us, the device busy over 100-300 and 600-700 us."""
    return types.SimpleNamespace(t0=0.0, t1=1000.0, window_s=1e-3, busy=[[100.0, 300.0], [600.0, 700.0]], busy_s=300e-6, host=host)


HOST = [
    ("fhmc.entry.pore_sweep", 50.0, 450.0),
    ("fhmc.prologue.sweep2d", 55.0, 70.0),
    ("fhmc.prologue.sweep2d", 68.0, 80.0),
    ("fhmc.launch.sweep2d", 80.0, 110.0),
    ("fhmc.post.fetch2d", 110.0, 400.0),
    ("fhmc.post.assemble2d", 400.0, 410.0),
    ("fhmc.post.assemble2d", 420.0, 440.0),
    ("fhmc.post.flood2d", 410.0, 420.0),
    ("aten::select", 0.0, 1000.0),
]


def test_host_ms_by_hand():
    # prologue 55-80 (25 us), assemble and flood 400-440 (40 us), over 2 calls
    read = harness.module("metrics", "sweep2d_host_ms").read
    assert read(types.SimpleNamespace(trace=_trace(HOST), traced=[{}, {}])) == pytest.approx(65 / 1e3 / 2, abs=1e-15)
    assert read(types.SimpleNamespace(trace=_trace([h for h in HOST if not h[0].startswith("fhmc.")]), traced=[{}])) is None
    assert read(types.SimpleNamespace(trace=None, traced=[])) is None


def test_program_idle_by_hand():
    # idle inside the entry: 50-450 less 100-300
    read = harness.module("metrics", "program_idle_pct.kernel_bound").read
    assert read(types.SimpleNamespace(trace=_trace(HOST), traced=[{}])) == pytest.approx(20.0, abs=1e-12)


def test_host_syncs_per_call(monkeypatch):
    """The counters read around each call; nothing to read where the program
    does not count the 2-D sweep."""
    from fhmcanalysis_torch.utils import profiling

    mod = harness.module("metrics", "sweep2d_host_syncs")
    counts = {}
    monkeypatch.setattr(profiling, "counters", lambda: dict(counts))
    calls = []
    for syncs in (1, 1, 2):
        c0 = {k: f() for k, f in mod.counters().items()}
        counts["host_syncs"] = counts.get("host_syncs", 0) + syncs
        counts["sweep2d.states"] = counts.get("sweep2d.states", 0) + 1024
        calls.append({"counters": {k: f() - c0[k] for k, f in mod.counters().items()}})
    assert mod.read(types.SimpleNamespace(calls=calls)) == pytest.approx(4 / 3)
    counts.clear()
    c0 = {k: f() for k, f in mod.counters().items()}
    counts["host_syncs"] = 5  # other entries' syncs, no 2-D sweep counted
    assert mod.read(types.SimpleNamespace(calls=[{"counters": {k: f() - c0[k] for k, f in mod.counters().items()}}])) is None
