"""The cell ig401.isogrid on the CPU at small sizes: it resolves by name and
reports exactly its metrics, every draw makes a lattice of exactly NX x NY
cells, a sound run is correct and counts its cells, a run whose grids
alter one cell is not, the float32 control is not, its reference and
inputs load neither JAX nor the program, and its three readers against
hand counts."""

import subprocess
import sys
import time
import types

import numpy as np
import pytest
from conftest import BENCH

from portbench import control, harness, roofline as R, roofline_iso as RI
from portbench.reference import iso

NAME = "ig401.isogrid"
SMALL = {"NX": 32, "NY": 9, "check_cells": 8, "trace_calls": 2}
SEED = 2**33 + 41


def run(over=SMALL, trace=False):
    return harness.run(NAME, SEED, 0.3, trace, time.perf_counter(), device="cpu", overrides=over, bench=BENCH)


def test_cell_resolves_and_reports_exactly_its_metrics():
    cell = harness.Cell(NAME, BENCH)
    assert cell.wl["entry"] == "iso_grid" and cell.cfg["name"] == "ig401" and cell.spec["chips"] == 1
    assert (cell.cfg["N"], cell.wl["NX"] * cell.wl["NY"], cell.cfg["reduced"]) == (401, 266240, [])
    e2e, layer = harness.metrics_of(BENCH, NAME)
    assert {m["name"] for m in e2e} == {"points_per_s", "setup_s"}
    assert {m["name"] for m in layer} == {"device_idle_pct.points", "program_idle_pct.points", "setup_import_s", "setup_kernel_load_s",
                                          "k3_roofline_pct", "iso_host_ms", "iso_host_syncs"}


@pytest.mark.parametrize("over", [{}, SMALL], ids=["cell", "small"])
def test_every_draw_is_exactly_nx_by_ny(over):
    """make_grid's ceil(width / delta) + 1 under the jitter, over many seeds,
    at the cell's own sizes and the tests'."""
    from fhmcanalysis_torch.binary.isopleth import isopleth

    cell = harness.Cell(NAME, BENCH, over)
    st = {"wl": cell.wl, "cfg": cell.cfg}
    src = np.array(cell.cfg["dmu2"])
    shape = isopleth._grids
    for seed in range(200):
        rng = np.random.default_rng([seed, 1])
        p = cell.entry.draw(st, rng)
        mu1_b, dmu2_b, delta = cell.entry.make(st, p)
        mu1, dmu2 = shape(None, mu1_b, dmu2_b, delta)
        assert (len(mu1), len(dmu2)) == (cell.wl["NX"], cell.wl["NY"])
        assert not cell.entry._undefined_row(src, dmu2_b, cell.wl["NY"])
        assert len(iso.axis(mu1_b, delta[0])) == cell.wl["NX"] and len(iso.axis(dmu2_b, delta[1])) == cell.wl["NY"]
        rows = sorted({i // cell.wl["NX"] for i in p["idx"]})
        quarter = cell.wl["NY"] // 4
        assert min(rows) < quarter and max(rows) >= 3 * quarter and len(p["idx"]) == cell.wl["check_cells"]


def test_rows_in_upstream_s_undefined_band_are_drawn_again():
    """A window whose rows come within 1e-5 of the source at dMu_2 = 1.10
    (np.isclose's band, outside 1e-9) is drawn again; one on the source
    itself, or clear of the band, is kept."""
    cell = harness.Cell(NAME, BENCH)
    src, NY = np.array(cell.cfg["dmu2"]), cell.wl["NY"]
    step = 5.0 / (NY - 1)
    on = (1.10 - 46 * step, 1.10 + 18 * step)  # row 46 lands on 1.10
    for shift, undefined in ((0.0, False), (3e-6, True), (-8e-6, True), (2e-5, False)):
        assert cell.entry._undefined_row(src, (on[0] + shift, on[1] + shift), NY) == undefined, shift


def test_sound_run_is_correct_and_counts_cells():
    r = run()
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] == 32 * 9 * r["calls"]
    assert r["metrics"]["points_per_s"]["value"] > 0


def test_altered_cell_is_not_correct(monkeypatch):
    """Grids with one sampled cell's F.E./kT moved, and with one cell's
    valid flag and fail code flipped: fe_gap, then seg_mismatch, fail."""
    cell = harness.Cell(NAME, BENCH, SMALL)
    import torch

    st = cell.entry.setup(cell.cfg, cell.wl, SEED, torch.device("cpu"))
    p = cell.entry.draw(st, np.random.default_rng(3))
    out = {k: np.array(v) for k, v in cell.entry.call(st, cell.entry.make(st, p)).items()}
    assert cell.entry.check(st, p, out) == {"seg_mismatch": 0, "fe_gap": 0.0, "prop_gap": 0.0}
    b = p["idx"][0]
    fe = out["F.E./kT"].reshape(-1)
    fe[b] = fe[b] * (1 + 1e-6) + 1e-6
    assert cell.entry.check(st, p, out)["fe_gap"] > cell.wl["limits"]["fe_gap"]
    out["valid"].reshape(-1)[b] = False
    out["fail_code"].reshape(-1)[b] = 2
    assert cell.entry.check(st, p, out)["seg_mismatch"] == 1
    assert cell.entry.check(st, p, {k: v[:, :-1] for k, v in out.items()})["seg_mismatch"] == len(p["idx"])


def test_float32_control_is_not_correct():
    over = dict(SMALL, check_calls=1)
    assert control.readings(NAME, SEED, "program", "cpu", over, BENCH)["correct"]
    assert not control.readings(NAME, SEED, "control", "cpu", over, BENCH)["correct"]


def test_reference_and_inputs_import_neither_jax_nor_the_program():
    code = ("import sys; sys.path.insert(0, '.'); import portbench.reference.iso, portbench.inputs_iso, portbench.roofline_iso; "
            "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300, cwd=harness.REPO)
    assert out.returncode == 0, out.stderr
    assert not set(out.stdout.split()) & (set(harness.FORBIDDEN) | {"fhmcanalysis_torch"})


def _trace(host, ops=()):
    """A window of 0-1000 us, the device busy over 100-300 and 600-700 us."""
    t = types.SimpleNamespace(t0=0.0, t1=1000.0, window_s=1e-3, busy=[[100.0, 300.0], [600.0, 700.0]], busy_s=300e-6, host=host, ops=list(ops))
    t.device_seconds = lambda match: sum(b - a for n, a, b in t.ops if match(n)) / 1e6
    return t


HOST = [
    ("fhmc.entry.make_grid", 50.0, 900.0),
    ("fhmc.prologue.iso_bracket", 55.0, 80.0),
    ("fhmc.prologue.iso", 80.0, 120.0),
    ("fhmc.launch.mb_rows", 90.0, 95.0),
    ("fhmc.launch.k3", 120.0, 130.0),
    ("fhmc.post.iso_copy", 130.0, 800.0),
    ("aten::copy_", 130.0, 800.0),
]


def test_host_ms_by_hand():
    # bracket and prologue 55-120 (65 us), copies 130-800 (670 us), over 2 calls;
    # with K3 on the card until 600 us, the copies count from there (200 us):
    # a launch that ends before the copy span (the row former's) moves nothing
    read = harness.module("metrics", "iso_host_ms").read
    assert read(types.SimpleNamespace(trace=_trace(HOST), traced=[{}, {}])) == pytest.approx(735 / 1e3 / 2, abs=1e-15)
    k3 = [("void iso_grid_kernel<1, 8, false>(IsoArgs)", 140.0, 300.0), ("void iso_grid_kernel<1, 8, false>(IsoArgs)", 300.0, 600.0), ("mb_rows_kernel", 95.0, 100.0)]
    assert read(types.SimpleNamespace(trace=_trace(HOST, k3), traced=[{}, {}])) == pytest.approx(265 / 1e3 / 2, abs=1e-15)
    late = [("void iso_grid_kernel<1, 8, false>(IsoArgs)", 140.0, 800.0)]
    assert read(types.SimpleNamespace(trace=_trace(HOST, late), traced=[{}])) == pytest.approx(65 / 1e3, abs=1e-15)
    assert read(types.SimpleNamespace(trace=_trace([h for h in HOST if not h[0].startswith("fhmc.")]), traced=[{}])) is None
    assert read(types.SimpleNamespace(trace=None, traced=[])) is None


def test_host_syncs_per_call(monkeypatch):
    """The counters read around each call; nothing to read where the
    program does not count the lattice."""
    from fhmcanalysis_torch.utils import profiling

    mod = harness.module("metrics", "iso_host_syncs")
    counts = {}
    monkeypatch.setattr(profiling, "counters", lambda: dict(counts))
    calls = []
    for syncs in (5, 5, 5, 10):
        c0 = {k: f() for k, f in mod.counters().items()}
        counts["host_syncs"] = counts.get("host_syncs", 0) + syncs
        counts["iso.cells"] = counts.get("iso.cells", 0) + 266240
        calls.append({"counters": {k: f() - c0[k] for k, f in mod.counters().items()}})
    assert mod.read(types.SimpleNamespace(calls=calls)) == pytest.approx(25 / 4)
    counts.clear()
    c0 = {k: f() for k, f in mod.counters().items()}
    counts["host_syncs"] = 5  # syncs of other entries, no lattice counted
    assert mod.read(types.SimpleNamespace(calls=[{"counters": {k: f() - c0[k] for k, f in mod.counters().items()}}])) is None


def test_k3_ops_by_hand():
    assert RI.k3_ops(2) == (2 * (2 + 4 + 2 + 7) + 4, 3 * (2 * (4 + 7) + 4 + 2)) == (34, 84)
    assert RI.k3_ops(1) == (2 * 8 + 4, 3 * (2 * 4 + 6))
    # 3 x 2 cells of 4 bins at smooth 2, every cell one phase over its bins
    assert RI.lattice_ops(3, 2, 4, 2, 2) == 6 * 4 * (34 + 8) + 6 * 4 * (3 + R.EXP_OPS + 84)
    # 2 sources of 4 bins reading 3 moment rows; 3 + 2 axis values; 2 rows; 6 cells
    assert RI.lattice_bytes(2, 3, 4, 3, 2) == 2 * 5 * 4 * 8 + 5 * 8 + 2 * 2 * 12 + 6 * 29


def test_k3_roofline_by_hand():
    """The reader against the same count made by hand: two traced calls,
    K3 1 ms each on the device; other kernels' time does not count."""
    cell = harness.Cell(NAME, BENCH, SMALL)
    import torch

    st = cell.entry.setup(cell.cfg, cell.wl, SEED, torch.device("cpu"))
    draws = [cell.entry.draw(st, np.random.default_rng(s)) for s in (1, 2)]
    ops = [("void (anonymous namespace)::iso_grid_kernel<1, 8, false>(Args)", 0.0, 1000.0),
           ("void (anonymous namespace)::iso_grid_kernel<1, 8, false>(Args)", 1000.0, 2000.0),
           ("mbrows::mb_rows_kernel(Table)", 2000.0, 9000.0), ("not_iso_grid_kernel", 0.0, 5000.0)]
    ctx = types.SimpleNamespace(trace=_trace([], ops), traced=[{"p": p, "keep": {}} for p in draws], cfg=cell.cfg, wl=cell.wl, state=st, entry=cell.entry)
    d0 = min(st["comps"])
    rows = R.moment_rows(dict(st["comps"][d0], curr_mu=[0.0, d0], curr_beta=cell.cfg["beta"]), cell.cfg, 2)
    N, NX, NY = 401, 32, 9
    least = 0.0
    for p in draws:
        _, dmu2_b, delta = cell.entry.make(st, p)
        W = RI.sources_named(st["comps"], iso.axis(dmu2_b, delta[1]))
        assert W == 5  # rows from about -2.6 to 2.6 bracket all five sources
        least += max(RI.lattice_bytes(W, rows, N, NX, NY) / R.HBM_BYTES_PER_S, RI.lattice_ops(NX, NY, N, 10, 2) / R.FP64_OPS_PER_S)
    assert harness.module("metrics", "k3_roofline_pct").read(ctx) == pytest.approx(100.0 * least / 2e-3, rel=1e-12)
    ctx.trace = _trace([], ops[2:])
    assert harness.module("metrics", "k3_roofline_pct").read(ctx) is None


def test_traced_cpu_run_reads_what_a_cpu_run_holds():
    """A traced run on the CPU: no device trace, so the device readers are
    silent; the counter reader reads five copies a call."""
    r = run(trace=True)
    assert r["correct"]
    assert r["metrics"]["iso_host_syncs"]["value"] == 5.0
    assert "k3_roofline_pct" not in r["metrics"] and "iso_host_ms" not in r["metrics"]
