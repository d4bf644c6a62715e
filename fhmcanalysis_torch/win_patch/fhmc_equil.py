"""Window-equilibration checks for FHMCSimulation output.

Parity target: the reference's moments/win_patch/fhmc_equil.pyx — percent
error of energy and species counts over neighboring windows' overlap.

The PyTorch port's copy of the JAX package's ``win_patch/fhmc_equil.py``: host
numpy, the same arithmetic, report and side effects; it reads tables
through the port's ``native``.
"""

from __future__ import annotations

import copy
import os
import re

import numpy as np

from ..native import loadtxt_unpacked

from . import fhmc_patch as oP

__all__ = ["test_nebr_match", "test_window_match", "find_windows", "test_nebr_equil"]


def _read_bounds_from_lnpi(fname):
    with open(fname) as f:
        f.readline()  # description line
        data = re.split(r"_|:|\n| ", f.readline())
        ub = int(data[-2])
        data = re.split(r"_|:|\n| ", f.readline())
        lb = int(data[-2])
    return lb, ub


def _read_mom_meta(fname):
    with open(fname) as f:
        f.readline()
        data = re.split(r"_|:|\n| ", f.readline())
        nspec = int(data[-2])
        data = re.split(r"_|:|\n| ", f.readline())
        max_order = int(data[-2])
    return nspec, max_order


def test_nebr_match(seq1, seq2, per_err=1.0):
    """Compare extensive properties of two neighbors over their overlap.

    Parity: fhmc_equil.pyx:25-128 — %err of U (with ideal-gas zero guard)
    and of N_i (moment-column addressing), pass iff max < per_err.
    Returns (ipass, max_u_err, max_n_err).
    """
    combo_seq = [seq1, seq2]

    ub, lb = [0, 0], [0, 0]
    for i in range(2):
        lb[i], ub[i] = _read_bounds_from_lnpi(combo_seq[i][0])

    assert ub[0] < ub[1], "Windows are out of order"
    assert lb[0] < lb[1], "Windows are out of order"
    assert ub[0] > lb[1], "Neighboring windows do not overlap"
    dw = ub[0] - lb[1] + 1

    # energy column (U^1) is column 2 of the moments file
    max_order, nspec, uvals = [0, 0], [0, 0], []
    infos = []
    for i in range(2):
        info = loadtxt_unpacked(combo_seq[i][1])
        infos.append(info)
        nspec[i], max_order[i] = _read_mom_meta(combo_seq[i][1])
        assert max_order[i] >= 1, "Must record atleast 1st moment to get average property"
        uvals.append(info[2, :])

    assert max_order[0] == max_order[1], "Different maximum order in each window"
    assert nspec[0] == nspec[1], "Different number of species in each window"
    ov1 = uvals[0][len(uvals[0]) - dw :]
    ov2 = uvals[1][:dw]
    assert len(ov1) == len(ov2), "Bad overlap calculation"

    # ideal gas check (U = 0?) — per-element guard (fhmc_equil.pyx:96-104)
    max_u_err = -np.inf
    for a, b in zip(ov1, ov2):
        if a != 0.0:
            err = abs((a - b) / a) * 100.0
        elif b != 0.0:
            err = abs((a - b) / b) * 100.0
        else:
            err = -np.inf
        max_u_err = max(max_u_err, err)

    # N_1, N_2, ... columns (fhmc_equil.pyx:107-122)
    mo = max_order[0] + 1
    max_n_err = 0.0
    for j in range(nspec[0]):
        address = 1 + (mo * mo * nspec[0] * 1 + mo * mo * nspec[0] * mo * j)
        ov1 = infos[0][address, :][len(infos[0][address, :]) - dw :]
        ov2 = infos[1][address, :][:dw]
        assert len(ov1) == len(ov2), "Bad overlap calculation"
        max_n_err = max(max_n_err, float(np.max(np.abs((ov2 - ov1) / ov1)) * 100.0))

    ipass = bool(max(max_u_err, max_n_err) < per_err)
    return ipass, max_u_err, max_n_err


def _latest_files(d, min_cp=-1):
    """Pick final_* files or the latest complete checkpoint set in dir d
    (fhmc_equil.pyx:166-214)."""
    files = os.listdir(d)
    if "final_lnPI.dat" in files:
        return (
            d + "/final_lnPI.dat",
            d + "/final_extMom.dat",
            d + "/final_eHist.dat",
            d + "/final_pkHist",
        )
    l, m, p, q = [], [], [], []
    min_cp_reached = np.inf
    found = {"tmmc": False, "mom": False, "eh": False, "ph": False}
    for f in files:
        if "tmmc-Checkpoint-" in f and "_lnPI.dat" in f:
            l.append(f)
            found["tmmc"] = True
            min_cp_reached = min(min_cp_reached, int(re.split(r"_|-|\.", f)[2]))
        if "extMom-Checkpoint-" in f and ".dat" in f:
            m.append(f)
            found["mom"] = True
            min_cp_reached = min(min_cp_reached, int(re.split(r"_|-|\.", f)[2]))
        if "eHist-Checkpoint-" in f and ".dat" in f:
            p.append(f)
            found["eh"] = True
            min_cp_reached = min(min_cp_reached, int(re.split(r"_|-|\.", f)[2]))
        if "pkHist-Checkpoint-" in f and "_1.dat" in f:
            q.append(f)
            found["ph"] = True
            min_cp_reached = min(min_cp_reached, int(re.split(r"_|-|\.", f)[2]))
    if all(found.values()) and min_cp_reached >= min_cp:
        oP.sort_nicely(l)
        oP.sort_nicely(m)
        oP.sort_nicely(p)
        oP.sort_nicely(q)
        return (d + "/" + l[-1], d + "/" + m[-1], d + "/" + p[-1], d + "/" + q[-1].split("_")[0])
    return None


def test_window_match(win1_dir, win2_dir, per_err=1.0, min_cp=-1):
    """Directory-level neighbor comparison (fhmc_equil.pyx:132-282)."""
    seqs = []
    for d in (win1_dir, win2_dir):
        s = _latest_files(d, min_cp)
        if s is None:
            raise Exception("Could not locate complete data in %s" % d)
        seqs.append(s)
    return test_nebr_match(seqs[0], seqs[1], per_err)


def find_windows(idir):
    """Ordered, continuous labeled window dirs with >= 1 tmmc checkpoint.

    Parity: fhmc_equil.pyx:284-337.  Returns (windows array, neighbor
    pair list).
    """
    d0 = idir[:-1] if idir.endswith("/") else copy.copy(idir)

    win_dir = [f for f in os.listdir(d0) if not os.path.isfile(os.path.join(d0 + "/", f))]
    passed = []
    for d in win_dir:
        files = os.listdir(d0 + "/" + d)
        cps = [fi for fi in files if ("tmmc-Checkpoint-" in fi and "_lnPI.dat" in fi)]
        max_cp = 0
        for c in cps:
            max_cp = max(max_cp, int(re.split(r"_|-", c)[2]))
        if max_cp >= 1:
            passed.append(int(d))
    passed = sorted(passed)

    ub = passed[0]
    for i in range(1, len(passed)):
        if passed[i] - passed[i - 1] == 1:
            ub += 1
        else:
            break
    windows = np.arange(passed[0], ub + 1)

    nebr_set = [(i, i + 1) for i in range(windows[0], windows[-1])]
    return windows, nebr_set


def test_nebr_equil(seq, per_err, fname="maxEq", trust=False, match_fn=None, win_idx=-2):
    """Walk neighbor pairs until the first unconverged one; write report.

    Parity: fhmc_equil.pyx:339-434 (window-index continuity checks,
    `trust` includes the last window, maxEq report format).  match_fn and
    win_idx parameterize the walk for the chkpt/feasst front-ends (their
    window number sits at a different path depth and their records need
    normalization, chkpt_equil.pyx:177, feasst_equil.pyx:144).
    """
    if match_fn is None:
        match_fn = test_nebr_match
    ordered_seq = []
    l_w = u_w = None
    for i in range(len(seq) - 1):
        if i == 0:
            for j in range(len(seq[i])):
                x = seq[i][j].split("/")
                w = int(x[win_idx])
                if j == 0:
                    l_w = w
                else:
                    assert l_w == w, "Window changes within sequence"
        else:
            l_w = u_w

        for j in range(len(seq[i + 1])):
            x = seq[i + 1][j].split("/")
            w = int(x[win_idx])
            if j == 0:
                u_w = w
            else:
                assert u_w == w, "Window changes within sequence"

        if u_w == l_w + 1:
            ordered_seq.append((seq[i], seq[i + 1]))
        else:
            break

    print_file = fname != "None"
    output = None
    if print_file:
        output = open(fname, "w")
        output.write("#\tParameters used:\n")
        output.write("#\tpercent_err = " + str(per_err) + "\n")
        output.write("#\t(window i, window j)\tMax(%)_err\tMax(%U)_err\tMax(%N_i)_err")

    safe_seq = []
    found = False
    w1 = w2 = None
    for l_seq, u_seq in ordered_seq:
        ipass, max_u_err, max_n_err = match_fn(l_seq, u_seq, per_err)
        if ipass:
            found = True
            if trust:
                if len(safe_seq) == 0:
                    safe_seq.append(l_seq)
                safe_seq.append(u_seq)
            else:
                safe_seq.append(l_seq)
            if print_file:
                w1 = int(l_seq[0].split("/")[win_idx])
                w2 = int(u_seq[0].split("/")[win_idx])
                output.write(
                    "\n#\t(%d,%d)\t%s\t%s\t%s" % (w1, w2, max(max_u_err, max_n_err), max_u_err, max_n_err)
                )
        else:
            break

    if print_file:
        if not found:
            output.close()
            raise Exception("No safe windows found")
        output.write("\n" + str(w2 if trust else w1))
        output.close()

    return safe_seq
