"""The readers of the program's spans and counters on a made-up trace and
made-up counters, against hand counts; and nothing to read where the
program has no spans or counters (a program from before them)."""

import types

import pytest

from portbench import harness, spans

READERS = ("program_idle_pct.kernel_bound", "program_idle_pct.points", "mb_prologue_ms", "setup_import_s", "setup_kernel_load_s")


def _trace(host):
    """A window of 0-1000 us, the device busy over 100-300 and 600-700 us."""
    busy = [[100.0, 300.0], [600.0, 700.0]]
    return types.SimpleNamespace(t0=0.0, t1=1000.0, window_s=1e-3, busy=busy, busy_s=300e-6, host=host)


# two entries, one more begun before the window; the harness's own ranges
# and torch's operators around and inside them
HOST = [
    ("portbench.call", 40.0, 460.0),
    ("fhmc.entry.mb_sweep", -100.0, 20.0),
    ("fhmc.entry.mb_sweep", 50.0, 450.0),
    ("fhmc.prologue.mb_targets", 60.0, 80.0),
    ("fhmc.prologue.mb_rows", 80.0, 95.0),
    ("fhmc.prologue.mb_rows", 90.0, 99.0),
    ("aten::select", 0.0, 1000.0),
    ("fhmc.launch.k2", 99.0, 110.0),
    ("fhmc.entry.mb_sweep", 500.0, 950.0),
    ("fhmc.prologue.reweight", 510.0, 530.0),
]


def _read(name, ctx):
    return harness.module("metrics", name).read(ctx)


@pytest.mark.parametrize("name", ["program_idle_pct.kernel_bound", "program_idle_pct.points"])
def test_program_idle_by_hand(name):
    # idle inside the entries: 0-20 (clipped), 50-450 less 100-300, 500-950 less 600-700
    ctx = types.SimpleNamespace(trace=_trace(HOST), traced=[{}, {}])
    got = _read(name, ctx)
    assert got == pytest.approx(100.0 * (20 + 200 + 350) / 1000, abs=1e-12)
    assert got <= 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)


def test_prologue_ms_by_hand():
    # the union of 60-80, 80-95, 90-99 and 510-530 is 39 + 20 us, over 2 calls
    ctx = types.SimpleNamespace(trace=_trace(HOST), traced=[{}, {}])
    assert _read("mb_prologue_ms", ctx) == pytest.approx((39 + 20) / 1e3 / 2, abs=1e-15)


def test_interval_helpers_by_hand():
    assert spans.union([(5, 7), (0, 2), (2, 3), (6, 9)]) == [[0, 3], [5, 9]]
    assert spans.overlap([[0, 3], [5, 9]], [[1, 6], [8, 20]]) == 2 + 1 + 1


@pytest.mark.parametrize("name", ["program_idle_pct.points", "mb_prologue_ms"])
def test_nothing_to_read_without_spans(name):
    host = [(n, a, b) for n, a, b in HOST if not n.startswith("fhmc.")]
    assert _read(name, types.SimpleNamespace(trace=_trace(host), traced=[{}])) is None
    assert _read(name, types.SimpleNamespace(trace=None, traced=[])) is None


def test_setup_counters(monkeypatch):
    from fhmcanalysis_torch.utils import profiling

    ctx = types.SimpleNamespace(trace=None, traced=[])
    monkeypatch.setattr(profiling, "counters", lambda: {"setup.import_s": 1.5, "kernel.load_s": 0.25, "kernel.loads": 3})
    assert _read("setup_import_s", ctx) == 1.5 and _read("setup_kernel_load_s", ctx) == 0.25
    monkeypatch.setattr(profiling, "counters", lambda: {"setup.import_s": 1.5, "kernel.load_s": 0.25, "kernel.build_s": 12.0})
    assert _read("setup_kernel_load_s", ctx) == 12.25
    monkeypatch.setattr(profiling, "counters", dict)
    assert _read("setup_import_s", ctx) is None and _read("setup_kernel_load_s", ctx) is None
    monkeypatch.delattr(profiling, "counters")
    assert _read("setup_import_s", ctx) is None and _read("setup_kernel_load_s", ctx) is None


def test_readers_are_listed():
    listed = {m["name"]: m for m in harness.benchmark()["per_layer"]}
    for name in READERS:
        assert name in listed and callable(harness.module("metrics", name).read)
