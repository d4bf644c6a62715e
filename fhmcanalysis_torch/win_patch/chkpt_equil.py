"""Equilibration checks for checkpoint (unnormalized) window dumps.

Parity: the reference's moments/win_patch/chkpt_equil.pyx — identical to
the fhmc checks except every moment record is divided by the visit-count
row (chkpt_equil.pyx:87, 115) and the U zero-guard uses a 1e-9 tolerance.

The PyTorch port's copy of the JAX package's ``win_patch/chkpt_equil.py``: host
numpy, the same arithmetic, report and side effects; it reads tables
through the port's ``native``.
"""

from __future__ import annotations

import numpy as np

from ..native import loadtxt_unpacked

from .fhmc_equil import _read_bounds_from_lnpi, _read_mom_meta, test_nebr_equil as _walk

__all__ = ["test_nebr_match_", "test_nebr_equil"]


def test_nebr_match_(seq1, seq2, per_err=1.0):
    """Neighbor convergence on count-normalized records
    (chkpt_equil.pyx:25-129)."""
    combo_seq = [seq1, seq2]

    ub, lb = [0, 0], [0, 0]
    for i in range(2):
        lb[i], ub[i] = _read_bounds_from_lnpi(combo_seq[i][0])

    assert ub[0] < ub[1], "Windows are out of order"
    assert lb[0] < lb[1], "Windows are out of order"
    assert ub[0] > lb[1], "Neighboring windows do not overlap"
    dw = ub[0] - lb[1] + 1

    max_order, nspec, uvals, infos = [0, 0], [0, 0], [], []
    for i in range(2):
        info = loadtxt_unpacked(combo_seq[i][1])
        infos.append(info)
        nspec[i], max_order[i] = _read_mom_meta(combo_seq[i][1])
        assert max_order[i] >= 1, "Must record atleast 1st moment to get average property"
        uvals.append(info[2, :] / info[1, :])  # normalize energy records

    assert max_order[0] == max_order[1], "Different maximum order in each window"
    assert nspec[0] == nspec[1], "Different number of species in each window"
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

    mo = max_order[0] + 1
    max_n_err = 0.0
    for j in range(nspec[0]):
        address = 1 + (mo * mo * nspec[0] * 1 + mo * mo * nspec[0] * mo * j)
        nv1 = infos[0][address, :] / infos[0][1, :]
        nv2 = infos[1][address, :] / infos[1][1, :]
        ov1 = nv1[len(nv1) - dw :]
        ov2 = nv2[:dw]
        assert len(ov1) == len(ov2), "Bad overlap calculation"
        max_n_err = max(max_n_err, float(np.max(np.abs((ov2 - ov1) / ov1)) * 100.0))

    ipass = bool(max(max_u_err, max_n_err) < per_err)
    return ipass, max_u_err, max_n_err


def test_nebr_equil(seq, per_err, fname="maxEq", trust=False):
    """Neighbor-equilibration walk using checkpoint-normalized records
    (chkpt_equil.pyx:131-227)."""
    return _walk(seq, per_err, fname, trust, match_fn=test_nebr_match_, win_idx=-3)
