"""The 2-D state sweeps' spans and counters (utils.profiling) on the CPU.

Under a profiler a pore or joint sweep is one fhmc.entry.pore_sweep /
fhmc.entry.joint_sweep range with its prologue (fhmc.prologue.sweep2d),
the queueing of its device stages (fhmc.launch.sweep2d) and its back half
(fhmc.post.fetch2d, fhmc.post.flood2d, fhmc.post.assemble2d) nested
inside it in time.  The counters move by what a sweep does: sweep2d.states
by its states, sweep2d.elev_tie by the states its device watershed flags,
sweep2d.flood_states by the states flooded on the host, host_syncs by one
a fetch of results.  Recording changes no output bit.
"""

import numpy as np
import pytest
import torch

import fhmcanalysis_torch.two_dim as T2
import fhmcanalysis_torch.utils.profiling as TPr
from torch_composites import FH_COEFFS, TWO_BASIN_BETA, TWO_BASIN_MU_REF, joint, pore13_entries, pore_states, tie_joint, two_basin_entries

torch.set_num_threads(1)
STATES = pore_states(6)
TARGETS = np.array([[0.2, -0.3], [0.5, -0.1], [-0.2, 0.4]])
DEVICE_ROUTE = ["fhmc.launch.sweep2d", "fhmc.post.assemble2d", "fhmc.post.assemble2d", "fhmc.post.fetch2d", "fhmc.prologue.sweep2d", "fhmc.prologue.sweep2d"]
HOST_ROUTE = ["fhmc.launch.sweep2d", "fhmc.launch.sweep2d", "fhmc.post.assemble2d", "fhmc.post.fetch2d", "fhmc.post.fetch2d", "fhmc.post.flood2d",
              "fhmc.prologue.sweep2d", "fhmc.prologue.sweep2d"]


def _pore(engine, jh=None, **kw):
    jh = joint(pore13_entries()) if jh is None else jh
    fh = T2.free_energy_profile.polynomial(FH_COEFFS).free_energy
    return T2.pore_state_sweep(jh, fh, *STATES, 1.0, nnebr=1, max_peaks=4, segment_engine=engine, device="cpu", **kw)


def _joint(engine):
    return T2.joint_state_sweep(joint(two_basin_entries()), TWO_BASIN_BETA, TWO_BASIN_MU_REF, TARGETS, nnebr=1, max_peaks=4, segment_engine=engine, device="cpu")


def _spans(prof) -> list:
    """The profile's fhmc.* events as (name, start, end), each a CPU range
    that is not a user annotation."""
    out = []
    for e in prof.events():
        if e.name.startswith("fhmc."):
            assert e.device_type.name == "CPU" and not e.is_user_annotation, e.name
            out.append((e.name, e.time_range.start, e.time_range.end))
    return out


@pytest.mark.parametrize(
    "run, entry, inside",
    [
        (lambda: _pore("device"), "fhmc.entry.pore_sweep", DEVICE_ROUTE),
        (lambda: _pore("host"), "fhmc.entry.pore_sweep", HOST_ROUTE),
        (lambda: _joint("device"), "fhmc.entry.joint_sweep", DEVICE_ROUTE),
        (lambda: _joint("host"), "fhmc.entry.joint_sweep", HOST_ROUTE),
    ],
    ids=["pore-device", "pore-host", "joint-device", "joint-host"],
)
def test_entry_span_holds_its_layers(tmp_path, run, entry, inside):
    """One entry span; every other span of the sweep lies within it, the
    prologue before the first launch and the back half after it."""
    with TPr.trace(str(tmp_path)) as prof:
        run()
    spans = _spans(prof)
    (a, b), = [(s, t) for n, s, t in spans if n == entry]
    assert sorted(n for n, s, t in spans if n != entry) == inside
    assert all(a <= s and t <= b for n, s, t in spans)
    launch = min(s for n, s, t in spans if n == "fhmc.launch.sweep2d")
    assert all(t <= launch for n, s, t in spans if n.startswith("fhmc.prologue."))
    assert all(s >= launch for n, s, t in spans if n.startswith("fhmc.post."))


def _moved(run) -> dict:
    names = ("sweep2d.states", "sweep2d.elev_tie", "sweep2d.flood_states", "host_syncs")
    before = TPr.counters()
    run()
    after = TPr.counters()
    return {k: after.get(k, 0) - before.get(k, 0) for k in names}


def test_counters_follow_the_sweep():
    """Device route: one fetch, nothing flooded; host route: the surfaces'
    fetch and the per-phase outputs' fetch, every state flooded; on a
    surface with an exact tie the device watershed flags every state, and
    the tie fallback floods them with two fetches more."""
    S = len(STATES[0])
    assert _moved(lambda: _pore("device")) == {"sweep2d.states": S, "sweep2d.elev_tie": 0, "sweep2d.flood_states": 0, "host_syncs": 1}
    assert _moved(lambda: _pore("host")) == {"sweep2d.states": S, "sweep2d.elev_tie": 0, "sweep2d.flood_states": S, "host_syncs": 2}
    assert _moved(lambda: _joint("device")) == {"sweep2d.states": 3, "sweep2d.elev_tie": 0, "sweep2d.flood_states": 0, "host_syncs": 1}
    tied = tie_joint(joint(pore13_entries()))
    assert _moved(lambda: _pore("device", tied)) == {"sweep2d.states": S, "sweep2d.elev_tie": S, "sweep2d.flood_states": 0, "host_syncs": 1}
    assert _moved(lambda: _pore("device", tied, tie_fallback=True)) == {"sweep2d.states": S, "sweep2d.elev_tie": S, "sweep2d.flood_states": S, "host_syncs": 3}


def _equal(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        if k == "local_maxima":
            assert all(np.array_equal(x, y) for x, y in zip(a[k], b[k], strict=True))
        elif k == "prop_names":
            assert a[k] == b[k]
        else:
            x, y = (v.numpy() if torch.is_tensor(v) else np.asarray(v) for v in (a[k], b[k]))
            assert x.dtype == y.dtype and np.array_equal(x, y, equal_nan=x.dtype.kind == "f"), k


@pytest.mark.parametrize("run", [lambda: _pore("device", return_surfaces=False), lambda: _pore("host"), lambda: _joint("device")], ids=["pore-device", "pore-host", "joint-device"])
def test_recording_changes_no_output_bit(tmp_path, monkeypatch, run):
    """A sweep under the profiler returns an untraced sweep's outputs bit for
    bit; without a profiler no span reaches the recording primitive."""
    with TPr.trace(str(tmp_path)):
        traced = run()

    def refuse(name):
        raise AssertionError(f"span {name} recorded with no profiler running")

    monkeypatch.setattr(TPr, "_Range", refuse)
    _equal(traced, run())
