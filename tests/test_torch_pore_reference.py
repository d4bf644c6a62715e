"""PyTorch port: the slit-pore state sweep (two_dim.pore_state_sweep) on
the CPU against the benchmark's plain reference of pore_hist.pyx
(portbench/reference/pore.py: a heapq priority flood and a running
boundary loop, sharing no code with the port), on a 24 x 97 cut of the
benchmark's pore96 surface, every state checked, with the host flood
(segment_engine "host") and with the device watershed run on the CPU
("device").

Bars: n_phases, phase_ok, ridge_ok, fail_code, local_maxima and labels
equal.  fe, the probability averages and the activation matrices within
1e-12 absolute: the two sides sum in other orders (the port's per-phase
sums over the masked [S, P, H, N] stack and its one-hot boundary
reductions, the reference's sums over one phase's cells and its running
logaddexp over boundary pairs); at |U| averages up to ~150 and |fe| ~ 50
one f64 rounding is 1e-14 to 3e-14 (the widest seen here: 6.4e-14), and
1e-12 leaves some thirty of them.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import fhmcanalysis_torch.two_dim as T2
from fhmcanalysis_torch.two_dim.pore_pipeline import _footprint

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench import inputs_pore  # noqa: E402
from portbench.reference import pore  # noqa: E402

torch.set_num_threads(1)
CFG = {"A": 1.0, "fh": [0.1, 0.0], "nnebr": 1, "max_peaks": 4}
H, N = 24, 97
P_VALS = np.linspace(0.0, 0.02, 8)
BETAS = np.linspace(1.08, 0.92, 8)
ATOL = 1e-12  # see the module's docstring
INTS = ("n_phases", "phase_ok", "ridge_ok", "fail_code", "labels")


def _joint(rows):
    jh = T2.joint_hist()
    for r in rows:
        jh.enter(*r)
    jh.make()
    return jh


def _sweep(jh, engine):
    fh = T2.free_energy_profile.polynomial(CFG["fh"]).free_energy
    return T2.pore_state_sweep(jh, fh, P_VALS, BETAS, CFG["A"], nnebr=CFG["nnebr"], max_peaks=CFG["max_peaks"], segment_engine=engine, device="cpu")


def _same(got, want):
    for k in INTS:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)
    for a, b in zip(got["local_maxima"], want["local_maxima"], strict=True):
        np.testing.assert_array_equal(a, b)
    assert list(got["prop_names"]) == want["prop_names"]
    live = want["phase_ok"]
    pair = live[:, :, None] & live[:, None, :]
    for k, where in (("fe", live), ("ave", live[..., None]), ("act_kT", pair), ("act_kT_diff", pair)):
        g, w = np.asarray(got[k]), np.asarray(want[k])
        np.testing.assert_allclose(np.where(where, g, 0.0), np.where(where, w, 0.0), rtol=0, atol=ATOL, err_msg=k)


@pytest.mark.parametrize("engine", ["host", "device"])
@pytest.mark.parametrize("seed", [5, 2**31 + 77])
def test_port_matches_the_reference(engine, seed):
    rows = inputs_pore.rows(H, N, seed)
    out = _sweep(_joint(rows), engine)
    want = pore.states(inputs_pore.assemble(rows), CFG, P_VALS, BETAS, torch.float64)
    got = pore.rows(out, range(len(P_VALS)))
    _same(got, want)
    assert (want["n_phases"] == 2).all() and (want["fail_code"] == 0).all()  # the cell's surface: two phases, none failing
    assert not out["elev_tie"].any()
    assert pore.numbers(got, want) == {"seg_mismatch": 0, "fe_gap": pytest.approx(0.0, abs=ATOL), "prop_gap": pytest.approx(0.0, abs=ATOL)}


def test_an_exact_tie_is_flagged():
    """Two cells of one footprint window given one value: each row's shift
    is a constant, so the tie survives every state.  The device watershed
    flags it (elev_tie, fail_code 4); the host flood and the reference
    flood it by the same rules, and agree."""
    rows = inputs_pore.rows(H, N, 11)
    op1, ln, ops, props = rows[6]
    ln = ln.copy()
    ln[8] = ln[7]
    rows[6] = (op1, ln, ops, props)
    jh = _joint(rows)
    dev = _sweep(jh, "device")
    assert dev["elev_tie"].all() and (dev["fail_code"] == 4).all()
    host = _sweep(jh, "host")
    assert not host["elev_tie"].any()
    _same(pore.rows(host, range(len(P_VALS))), pore.states(inputs_pore.assemble(rows), CFG, P_VALS, BETAS, torch.float64))


@pytest.mark.parametrize("shape", [(96, 385), (24, 97), (13, 21), (385, 96), (2, 2)])
@pytest.mark.parametrize("nnebr", [1, 2])
def test_footprint_matches_the_port(shape, nnebr):
    assert pore.footprint(*shape, nnebr) == _footprint(*shape, nnebr).shape


@pytest.mark.parametrize("form", ["zeroed_valid", "whole_edge_index"])
def test_the_literal_pyx_lines_fail_every_state(form):
    """The two places where the reference, like the port, follows the
    intended form of pore_hist.pyx rather than its letter, each read
    literally on every state of the surface above.  :412-413 zeroes the
    valid cells of the shifted surface instead of the background: every
    valid cell is then a maximum of its window, so peak_local_max finds as
    many peaks as there are cells and every state fails "Cannot segment"
    (fail code 3).  :230-234 index the edge columns with the whole array:
    read with numpy's rules, each row gives its cells at every row's edge
    column, interior cells among them, and the phase whose hill lies under
    those columns meets its own peak region there; its margin falls from
    ~39 to under 1 and every state fails the ridgeline guard (fail code
    1).  The intended forms give two phases and fail code 0."""
    s = inputs_pore.assemble(inputs_pore.rows(H, N, 5))
    edge, rows = s["edge"], np.arange(H)
    for p, beta in zip(P_VALS, BETAS):
        want = pore.state(s, CFG, float(p), float(beta), torch.float64)
        assert want["n_phases"] == 2 and want["fail_code"] == 0
        ln, valid = (t.numpy() for t in pore.surface(s, CFG["fh"], float(p), CFG["A"], float(beta), torch.float64))
        if form == "zeroed_valid":
            x = np.where(valid, 0.0, ln - ln[valid].min())
            assert len(pore.peaks(x, pore.footprint(H, N, CFG["nnebr"]), int(valid.sum()))) == valid.sum()
            continue
        margins = []
        for hill in (1, 2):
            mask = want["labels"] == hill
            own = np.where(mask[rows, edge], ln[rows, edge], -np.inf).max()
            whole = np.where(mask[:, edge], ln[:, edge], -np.inf).max()
            margins.append((ln[mask].max() - own, ln[mask].max() - whole))
        assert min(m[0] for m in margins) >= pore.PORE_CUTOFF > min(m[1] for m in margins)
