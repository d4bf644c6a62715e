"""The port's spans and counters (``utils.profiling``) on the CPU.

Under a profiler, each entry is one ``fhmc.entry.*`` range on the host's
thread with its prologues, launches and copies nested inside, every one a
CPU range and none a user annotation (a user annotation is copied onto the
device's timeline, where it would read as device work).  Without a
profiler a span records nothing.  The counters move by what each loop
does: a Nelder-Mead block of ``SYNC_EVERY`` steps and one host test,
five copies a shard for ``make_grid``.
"""

import math
import sys
import threading

import numpy as np
import pytest
import torch

import fhmcanalysis_torch.core.pipeline as TP
import fhmcanalysis_torch.core.solve as TSV
import fhmcanalysis_torch.core.state as TS
import fhmcanalysis_torch.utils.profiling as TPr
from fhmcanalysis_torch.binary import isopleth
from fhmcanalysis_torch.parallel import grid_mesh
from torch_composites import ISO31, cell, iso_grid_args, iso_sources, mb_grid, port_histogram

torch.set_num_threads(1)
LNPI = np.array([0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 9, 8, 7, 6, 5, 4, 3, 2, 1, 0, 1, 2, 3, 4, 5, 4, 3, 2, 1, 0], dtype=np.float64)


def _spans(prof) -> list:
    """The profile's fhmc.* events as (name, start, end), each checked to be
    a CPU range that is not a user annotation."""
    out = []
    for e in prof.events():
        if e.name.startswith("fhmc."):
            assert e.device_type.name == "CPU" and not e.is_user_annotation, e.name
            out.append((e.name, e.time_range.start, e.time_range.end))
    return out


def _inside(spans, entry) -> list:
    """The names of the spans that lie within one span named entry, which
    must be the only one of that name."""
    (a, b), = [(s, t) for n, s, t in spans if n == entry]
    return sorted(n for n, s, t in spans if n != entry and a <= s and t <= b)


def _mb_inputs(M=4, A=3):
    d, mk, mus, betas, dmus = mb_grid(M, A)
    return TS.from_host(d, device="cpu"), TS.HistMeta(**mk), mus, betas, dmus


def _sweep(engine):
    d, mk, mus = cell("n31", 8)
    return TP.mu_sweep_thermo(TS.from_host(d, device="cpu"), TS.HistMeta(**mk), mus, engine=engine)


def _mb_sweep(engine):
    h, meta, mus, betas, dmus = _mb_inputs()
    return TP.mu_beta_sweep_thermo(h, meta, mus, betas, dmus, order=2, engine=engine)


@pytest.mark.parametrize(
    "run, entry, inside",
    [
        (_sweep, "fhmc.entry.mu_sweep", []),
        (_mb_sweep, "fhmc.entry.mb_sweep", ["fhmc.prologue.mb_rows", "fhmc.prologue.mb_targets"]),
    ],
    ids=["mu_sweep", "mb_sweep"],
)
def test_entry_spans_on_the_plain_engine(tmp_path, run, entry, inside):
    """engine "auto" on CPU tensors (the plain version): one entry span,
    the extrapolating sweep's prologues inside it, no launch span."""
    with TPr.trace(str(tmp_path)) as prof:
        run("auto")
    spans = _spans(prof)
    assert _inside(spans, entry) == inside
    assert {n for n, _, _ in spans} == {entry, *inside}


@pytest.mark.parametrize(
    "run, entry, inside",
    [
        (_sweep, "fhmc.entry.mu_sweep", ["fhmc.launch.k1", "fhmc.prologue.reweight"]),
        (_mb_sweep, "fhmc.entry.mb_sweep", ["fhmc.launch.mb_rows", "fhmc.prologue.mb_rows", "fhmc.prologue.mb_targets"]),
    ],
    ids=["mu_sweep", "mb_sweep"],
)
def test_entry_spans_on_the_kernel_route(tmp_path, run, entry, inside):
    """engine "cuda" on CPU tensors runs the kernel route's prologue until
    the first wrapper's checks refuse the tensors inside its launch span:
    K1's, after the prologue has ended; in the extrapolating sweep the row
    former's, which is the work of its rows' prologue and lies inside it,
    after the targets' prologue has ended."""
    with TPr.trace(str(tmp_path)) as prof:
        with pytest.raises(ValueError, match="CUDA tensors"):
            run("cuda")
    spans = _spans(prof)
    assert _inside(spans, entry) == inside
    launch, end = next((s, t) for n, s, t in spans if n.startswith("fhmc.launch."))
    assert all(t <= launch or (s <= launch and end <= t) for n, s, t in spans if n.startswith("fhmc.prologue."))
    assert [n for n, s, t in spans if n.startswith("fhmc.prologue.") and s <= launch and end <= t] == (["fhmc.prologue.mb_rows"] if run is _mb_sweep else [])


def test_make_grid_spans_and_copies(tmp_path):
    """make_grid: the bracket, the prologue and the copies inside the entry
    span; host_syncs moves by the five copies of each shard, iso.cells by
    the grid's cells."""
    ds, mk = iso_sources("n31", (-5.0, -4.0))
    iso = isopleth([port_histogram(d, mk, device="cpu") for d in ds], 1.02, order=1)
    grid = iso_grid_args(ISO31, NX=8, NY=4)
    names = ("host_syncs", "iso.cells")
    before = [TPr.counters().get(k, 0) for k in names]

    def moved():
        return [TPr.counters().get(k, 0) - b for k, b in zip(names, before)]

    with TPr.trace(str(tmp_path)) as prof:
        iso.make_grid(*grid)
    assert moved() == [5, 8 * 4]
    assert _inside(_spans(prof), "fhmc.entry.make_grid") == ["fhmc.post.iso_copy", "fhmc.prologue.iso", "fhmc.prologue.iso_bracket"]
    iso.make_grid(*grid, mesh=grid_mesh(3, devices=["cpu"] * 3))
    assert moved() == [5 + 15, 2 * 8 * 4]


def test_spans_record_nothing_without_a_profiler(monkeypatch):
    """No profiler: span is the one shared no-op and the decorated entries
    never reach the recording primitive."""

    def refuse(name):
        raise AssertionError(f"span {name} recorded with no profiler running")

    monkeypatch.setattr(TPr, "_Range", refuse)
    assert TPr.span("fhmc.entry.a") is TPr.span("fhmc.entry.b")
    with TPr.span("fhmc.entry.a"):
        pass
    _sweep("auto")
    _mb_sweep("auto")
    with pytest.raises(ValueError, match="CUDA tensors"):
        _sweep("cuda")


def test_solver_counters_follow_its_loop(tmp_path):
    """trace_coexistence: solver.steps moves by SYNC_EVERY a block and
    host_syncs by one stopping test a block (the plain objective reads
    nothing back), the blocks being the fewest that cover the most steps
    any beta took; the blocks and tests are spans inside the entry."""
    d, mk, _ = cell("n31", 1, max_order=3)
    h, meta = TS.from_host(dict(d, lnpi=LNPI), device="cpu"), TS.HistMeta(**dict(mk, max_phases=8))
    betas = (0.99, 1.0, 1.01)
    c0 = TPr.counters()
    with TPr.trace(str(tmp_path)) as prof:
        TSV.trace_coexistence(h, meta, betas, 5.0, lnZ_tol=1e-6, min_width=2)
    c1 = TPr.counters()
    _, n_iter = TSV._trace(h, meta, betas, 5.0, 1e-6, None, 1, 2, "auto")
    k = TSV.SYNC_EVERY
    blocks = max(1, math.ceil(int(n_iter.max()) / k))
    assert blocks > 1
    assert c1["solver.steps"] - c0.get("solver.steps", 0) == k * blocks
    assert c1["host_syncs"] - c0.get("host_syncs", 0) == blocks
    inside = _inside(_spans(prof), "fhmc.entry.trace_coexistence")
    assert inside == ["fhmc.solver.steps"] * blocks + ["fhmc.solver.test"] * blocks


def test_counters_add_up_across_threads():
    """Counters are added to from several threads (the kernel libraries load
    in parallel): no add is lost, with more threads than cores and the
    interpreter switching threads as often as it can."""
    threads, adds = 16, 2000
    before = TPr.counters().get("test.threads", 0)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        pool = [threading.Thread(target=lambda: [TPr.add("test.threads") for _ in range(adds)]) for _ in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in pool)
    finally:
        sys.setswitchinterval(interval)
    assert TPr.counters()["test.threads"] - before == threads * adds


def test_kernel_load_and_build_counters(tmp_path, monkeypatch):
    """_build.load counts a build's nvcc seconds apart from the load and the
    library's declaration (its signatures and checks), and keeps the
    compiler's output; a second process-wide load of the same library is
    the cached one.  A stand-in compiler copies a shared object."""
    import _ctypes
    import fhmcanalysis_torch._build as B

    nvcc = tmp_path / "nvcc"
    nvcc.write_text(f"#!{sys.executable}\nimport shutil, sys, time\ntime.sleep(0.3)\n"
                    f"shutil.copy({_ctypes.__file__!r}, sys.argv[sys.argv.index('-o') + 1])\nprint('ptxas info : stand-in')\n")
    nvcc.chmod(0o755)
    monkeypatch.setattr(B, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(B, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(B, "library_path", lambda name: tmp_path / "build" / f"lib{name}.so")
    declared = []
    c0 = TPr.counters()
    lib = B.load("stand_in_kernel", declared.append)
    c1 = TPr.counters()
    assert declared == [lib] and "stand-in" in B.BUILD_INFO["stand_in_kernel"]["log"]
    moved = {k: c1.get(k, 0) - c0.get(k, 0) for k in ("kernel.builds", "kernel.build_s", "kernel.loads", "kernel.load_s")}
    assert moved["kernel.builds"] == 1 and moved["kernel.loads"] == 1
    assert moved["kernel.build_s"] >= 0.3 > moved["kernel.load_s"] > 0
    assert B.load("stand_in_kernel", declared.append) is lib and TPr.counters()["kernel.loads"] == c1["kernel.loads"]
