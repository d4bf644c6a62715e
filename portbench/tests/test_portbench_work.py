"""The rooflines' work counts against hand counts at small sizes."""

import numpy as np
import pytest
import torch

from portbench import inputs, roofline as R


def test_covered_bins_by_hand():
    left = torch.tensor([[0, 5, 9], [2, -1, 0]])
    right = torch.tensor([[5, 9, 12], [7, 3, 0]])
    mask = torch.tensor([[True, True, False], [True, True, False]])
    # 5 + 4 (third slot masked); 5 + 3 (left clamped to 0); N = 10 clamps 12
    assert R.covered_bins(left, right, mask, 10) == 5 + 4 + 5 + 3
    mask[0, 2] = True
    assert R.covered_bins(left, right, mask, 10) == 5 + 4 + 1 + 5 + 3


def test_tail_ops_by_hand():
    # 3 points of 4 bins at smooth 2: x twice a bin, 8 compares a bin; 7 covered bins
    x_ops, key_ops = R.k1_ops(2)
    assert (x_ops, key_ops) == (2, 6)
    assert R.tail_ops(3, 4, 2, 7, x_ops, key_ops) == 3 * 4 * (2 + 8) + 7 * (3 + 26 + 6)


def test_k2_ops_by_hand():
    assert R.k2_ops(1, 1) == (6, 2 * 6)
    assert R.k2_ops(2, 2) == (2 + 4 + 2 + 7, 3 * (6 + 7))


@pytest.mark.parametrize("S", [1, 2])
def test_sweep_out_bytes_match_the_entry_s_outputs(S):
    """The byte count of the sweep's outputs is what the program returns."""
    from fhmcanalysis_torch.core import pipeline, state

    d = inputs.make_composite(31, S, 1.0, (5.0, 0.0)[:S], 3, 2, 40.0)
    h = state.from_host(d, device="cpu")
    meta = state.HistMeta(nspec=S, max_order=2, smooth=1, max_phases=3)
    out = pipeline.mu_sweep_thermo(h, meta, torch.linspace(4.0, 6.0, 5, dtype=torch.float64), props=True)
    assert R.sweep_out_bytes(5, 3, S) == sum(v.numel() * v.element_size() for v in out.values())


def test_moment_rows_by_hand():
    """One species at order 1 reads <N>, <U>, N U, N^2 and U^2; order 2
    reads more, and two species more again."""
    cfg1 = {"N": 31, "nspec": 1, "beta": 1.0, "mu0": [0.0], "volume": 40.0, "smooth": 1, "max_phases": 4, "max_order": 3}
    d1 = inputs.config_composite(cfg1, 5)
    assert R.moment_rows(d1, cfg1, 1) == 5
    assert R.moment_rows(d1, cfg1, 2) > 5
    cfg2 = dict(cfg1, nspec=2, mu0=[5.0, 0.0])
    assert R.moment_rows(inputs.config_composite(cfg2, 5), cfg2, 2) > R.moment_rows(d1, cfg1, 2)


def test_least_seconds_takes_the_larger_bound():
    assert R.least_seconds(3.35e12, 0) == pytest.approx(1.0)
    assert R.least_seconds(0, 34e12) == pytest.approx(1.0)
    assert R.least_seconds(3.35e12, 68e12) == pytest.approx(2.0)


def test_composites_repeat_from_the_seed():
    a = inputs.make_composite(31, 2, 1.0, (5.0, 0.0), 2**40 + 3, 3, 729.0)
    b = inputs.make_composite(31, 2, 1.0, (5.0, 0.0), 2**40 + 3, 3, 729.0)
    c = inputs.make_composite(31, 2, 1.0, (5.0, 0.0), 2**40 + 4, 3, 729.0)
    assert all(np.array_equal(a[k], b[k]) for k in ("lnpi", "mom"))
    assert np.array_equal(a["lnpi"], c["lnpi"]) and not np.array_equal(a["mom"], c["mom"])
