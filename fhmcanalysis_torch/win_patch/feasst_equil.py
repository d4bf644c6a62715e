"""Equilibration checks for FEASST window output.

Parity: the reference's moments/win_patch/feasst_equil.pyx — bounds come
from colMat column 0, moments from extMom_pr rows selected by exponent
pattern; default per_err is 3.0 (feasst_equil.pyx:144).

The PyTorch port's copy of the JAX package's ``win_patch/feasst_equil.py``: host
numpy, the same arithmetic, report and side effects; it reads tables
through the port's ``native``.
"""

from __future__ import annotations

import numpy as np

from ..native import loadtxt_unpacked, read_table

from .fhmc_equil import test_nebr_equil as _walk

__all__ = ["test_nebr_match_", "test_nebr_equil"]


def _read_meta(fname):
    nspec = order = 0
    with open(fname, "r") as f:
        for line in f:
            if line[0] == "#":
                if "maxOrder" in line:
                    order = int(line.strip().split(" ")[-1])
                elif "nSpec" in line:
                    nspec = int(line.strip().split(" ")[-1])
            else:
                break
    return nspec, order


def test_nebr_match_(seq1, seq2, per_err=1.0):
    """Neighbor convergence from colMat/extMom_pr pairs
    (feasst_equil.pyx:25-142)."""
    combo_seq = [seq1, seq2]

    nspec, order = [0, 0], [0, 0]
    for i in range(2):
        nspec[i], order[i] = _read_meta(combo_seq[i][1])
    assert order[0] == order[1], "Different maximum orders found"
    assert nspec[0] == nspec[1], "Different number of species found"

    ub, lb, mom, mom_exp = [0, 0], [0, 0], [], []
    for i in range(2):
        data = loadtxt_unpacked(combo_seq[i][0])
        lb[i] = int(data[0][0])
        ub[i] = int(data[0][-1])

        dummy_mom = read_table(combo_seq[i][1])
        mom.append(np.zeros(len(dummy_mom)))
        mom_exp.append(np.zeros((len(dummy_mom), 5)))
        for ctr, row in enumerate(dummy_mom):
            opIdx, nValues, Sum, SumSq, ii, jj, kk, mm, pp = row
            mom[i][ctr] = Sum / nValues
            mom_exp[i][ctr] = [ii, jj, kk, mm, pp]

    assert ub[0] < ub[1], "Windows are out of order"
    assert lb[0] < lb[1], "Windows are out of order"
    assert ub[0] > lb[1], "Neighboring windows do not overlap"
    dw = ub[0] - lb[1] + 1

    uvals = []
    for i in range(2):
        idx = np.where((mom_exp[i] == [0, 0, 0, 0, 1]).all(axis=1))[0]
        assert len(idx) == int(ub[i] - lb[i] + 1), (
            "Could not find energy entry for each value of the order parameter : %d vs %d"
            % (len(idx), ub[i] - lb[i] + 1)
        )
        uvals.append(mom[i][idx])

    ov1 = uvals[0][len(uvals[0]) - dw :]
    ov2 = uvals[1][:dw]
    assert len(ov1) == len(ov2), "Bad overlap calculation"

    tol = 1.0e-9
    max_u_err = -np.inf
    for a, b in zip(ov1, ov2):
        if abs(a) > tol:
            err = abs((a - b) / a) * 100.0
        elif abs(b) > tol:
            err = abs((a - b) / b) * 100.0
        else:
            err = -np.inf
        max_u_err = max(max_u_err, err)

    max_n_err = 0.0
    for j in range(nspec[0]):
        ni = []
        for i in range(2):
            idx = np.where((mom_exp[i] == [j, 1, 0, 0, 0]).all(axis=1))[0]
            assert len(idx) == int(ub[i] - lb[i] + 1), (
                "Could not find particle number entry for each value of the order parameter : %d vs %d"
                % (len(idx), ub[i] - lb[i] + 1)
            )
            ni.append(mom[i][idx])
        ov1 = ni[0][len(ni[0]) - dw :]
        ov2 = ni[1][:dw]
        assert len(ov1) == len(ov2), "Bad overlap calculation"
        max_n_err = max(max_n_err, float(np.max(np.abs((ov2 - ov1) / ov1)) * 100.0))

    ipass = bool(max(max_u_err, max_n_err) < per_err)
    return ipass, max_u_err, max_n_err


def test_nebr_equil(seq, per_err=3.0, fname="maxEq", trust=False):
    """Neighbor-equilibration walk over FEASST windows
    (feasst_equil.pyx:144-234)."""
    return _walk(seq, per_err, fname, trust, match_fn=test_nebr_match_)
