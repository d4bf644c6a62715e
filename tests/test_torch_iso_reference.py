"""PyTorch port: the binary isopleth lattice (isopleth.make_grid, engine
"torch") on the CPU against the benchmark's plain reference of gc_binary's
per-pixel composition (portbench/reference/iso.py: its own bracket, each
side reweighted and extrapolated to a full surface before the mix, sharing
no code with the port), on the benchmark's ig401 sources: the binary ideal
gas in closed form at N_tot 0-400, five dMu_2 sources at T = 1.20, the
surface at T = 1.10, order 2, m = 2.5, smooth 10.

Bars: valid and fail_code equal; x_1, density and F.E./kT within the
ig401.isogrid cell's limits (1e-9 relative).  On the CPU both sides form
x', the mix and the tail with the same operations in the same order, so
they agree bit for bit; the limit is what the cell holds the card to.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from fhmcanalysis_torch.binary import isopleth
from fhmcanalysis_torch.binary.isopleth import FAIL_EDGE_UNSAFE, _find_left_right
from fhmcanalysis_torch.histogram.ntot import histogram

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from portbench import inputs_iso  # noqa: E402
from portbench.reference import iso as ref  # noqa: E402

torch.set_num_threads(1)
CFG = json.loads((REPO / "portbench/configs/ig401.json").read_text())
WL = json.loads((REPO / "portbench/workloads/ig401.isogrid.json").read_text())
LIMITS = WL["limits"]
SEEDS = (3, 2**31 + 11, 2**33 + 5)


def _delta(b, n):
    return (b[1] - b[0]) / (n - 1) * (1 + 1e-9)


def _both(seed, mu1_b, dmu2_b, NX, NY, dtype=torch.float64):
    """(the program's grids, the reference's cells, its inputs) on one
    lattice of NY x NX cells."""
    comps = inputs_iso.sources(CFG, seed)
    hs = [histogram.from_composite(raw, CFG["beta"], [0.0, d], smooth=CFG["smooth"], device="cpu") for d, raw in comps.items()]
    it = isopleth(hs, CFG["beta_target"], order=CFG["order"])
    delta = (_delta(mu1_b, NX), _delta(dmu2_b, NY))
    it.make_grid(mu1_b, dmu2_b, delta, m=CFG["m"], engine="torch")
    mu1, dmu2 = ref.axis(mu1_b, delta[0]), ref.axis(dmu2_b, delta[1])
    assert (len(mu1), len(dmu2)) == (NX, NY)
    X, Y = np.meshgrid(mu1, dmu2)
    np.testing.assert_array_equal(X, it.data["X"])
    np.testing.assert_array_equal(Y, it.data["Y"])
    want = ref.cells(comps, CFG, X.ravel(), Y.ravel(), dtype)
    return it.data, want, comps, X, Y


def _agree(data, want):
    got = ref.rows(data, range(want["valid"].size))
    np.testing.assert_array_equal(got["valid"], want["valid"])
    np.testing.assert_array_equal(got["fail_code"], want["fail_code"])
    nums = ref.numbers(got, want)
    assert nums["seg_mismatch"] == 0 and all(nums[k] <= LIMITS[k] for k in LIMITS), nums
    return nums


@pytest.mark.parametrize("seed", SEEDS)
def test_port_matches_the_reference_on_the_cells_window(seed):
    data, want, _, _, _ = _both(seed, WL["mu1"], WL["dmu2"], 16, 9)
    _agree(data, want)
    assert want["valid"].all()


@pytest.mark.parametrize("seed", SEEDS[:2])
def test_edge_unsafe_cells_agree(seed):
    """Past mu_1 = -4 the gas fills the box: the tail of the reweighted
    sources or of the mixed surface comes within the cutoff of the last
    maximum, and those cells fail with FAIL_EDGE_UNSAFE on both sides."""
    data, want, _, _, _ = _both(seed, (-4.0, -3.0), WL["dmu2"], 16, 9)
    _agree(data, want)
    unsafe = want["fail_code"] == FAIL_EDGE_UNSAFE
    assert 0 < unsafe.sum() < unsafe.size and (want["fail_code"][~unsafe] == 0).all()


def test_rows_on_a_source_take_it_alone():
    """Rows at dMu_2 = -1.10, 0 and 1.10 lie on sources: each takes its
    source's surface unmixed (the one-source bracket, weights (1, 1)), and
    both sides agree there and on the mixed rows between."""
    data, want, comps, _, Y = _both(SEEDS[0], WL["mu1"], (-1.10, 1.10), 8, 5)
    src = np.array(sorted(comps))
    one = [ref.bracket(src, y) for y in Y[:, 0]]
    assert [a == b for a, b in one] == [True, False, True, False, True]
    _agree(data, want)


def test_a_row_near_a_source_raises_in_both():
    """A row 1e-6 from a source (inside np.isclose's tolerance, outside
    1e-9) raises "dmu2 values repeat" in the program and the reference
    alike, as upstream's find_left_right does; 1e-12 off it takes the
    source alone (the cell's draw keeps out of the band)."""
    src = np.array(CFG["dmu2"])
    for v in (-1.10 + 1e-6, -1.10 - 1e-6, 2.94 - 1e-6):
        with pytest.raises(Exception, match="repeat"):
            _find_left_right(src, v, True)
        with pytest.raises(ValueError, match="repeat"):
            ref.bracket(src, v)
    assert _find_left_right(src, 1.10 + 1e-12, True) == (3, 3) == ref.bracket(src, 1.10 + 1e-12)


def test_float32_reference_breaks_a_limit():
    data, _, comps, X, Y = _both(SEEDS[0], WL["mu1"], WL["dmu2"], 16, 9)
    want = ref.cells(comps, CFG, X.ravel(), Y.ravel(), torch.float64)
    low = ref.cells(comps, CFG, X.ravel(), Y.ravel(), torch.float32)
    nums = ref.numbers(low, want)
    assert any(nums[k] > LIMITS[k] for k in LIMITS), nums


@pytest.mark.parametrize("seed", SEEDS[:2])
def test_composition_and_pressure_hold_the_closed_form(seed):
    """The notebook's checks: x_1 and P = -F.E./kT / (V beta*) within 2% of
    the gas at (beta*, mu_1, dMu_2): x_1 = 1 / (1 + kappa exp(beta* dMu_2)),
    beta* P = exp(beta* mu_1) (1 + kappa exp(beta* dMu_2))."""
    data, _, _, X, Y = _both(seed, WL["mu1"], WL["dmu2"], 16, 9)
    b, k = CFG["beta_target"], inputs_iso.kappa(seed)
    x1 = 1.0 / (1.0 + k * np.exp(b * Y))
    P = np.exp(b * X) * (1.0 + k * np.exp(b * Y)) / b
    assert np.abs(data["Z"] - x1).max() < 0.02
    assert np.abs(-data["F.E./kT"] / CFG["volume"] / b / P - 1.0).max() < 0.02


def test_the_cells_lattice_is_one_phase_over_every_bin():
    """k3_roofline_pct counts N covered bins a cell: over the cell's widest
    jittered window (each end moved out by the jitter) every cell is one
    phase over [0, N), on a 64 x 17 sample of the lattice that includes
    its edges."""
    comps = inputs_iso.sources(CFG, SEEDS[2])
    j = WL["jitter"]
    lo, hi = WL["mu1"]
    mu1 = np.linspace(lo - j * (hi - lo), hi + j * (hi - lo), 64)
    lo, hi = WL["dmu2"]
    dmu2 = np.linspace(lo - j * (hi - lo), hi + j * (hi - lo), 17)
    X, Y = np.meshgrid(mu1, dmu2)
    want = ref.cells(comps, CFG, X.ravel(), Y.ravel(), torch.float64)
    N = CFG["N"]
    assert want["valid"].all()
    assert want["mask"][:, 0].all() and not want["mask"][:, 1:].any()
    assert (want["left"][:, 0] == 0).all() and (want["right"][:, 0] == N).all()
