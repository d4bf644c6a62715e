"""Window patching from FHMCSimulation *checkpoint* dumps.

Parity target: the reference's moments/win_patch/chkpt_patch.pyx —
the same pipeline as fhmc_patch but for unnormalized mid-run data:
local histograms normalize on load (chkpt_patch.pyx:85-101), moment
records normalize by the visit-count row (:442), discovery reads
checkpt/state.json and requires the TMMC crossover (:846-876).

The PyTorch port's copy of the JAX package's ``win_patch/chkpt_patch.py``: host
numpy, the same arithmetic and side effects; it reads tables through the
port's ``native`` and writes through the port's ``io``.
"""

from __future__ import annotations

import copy
import json
import os

import numpy as np

from ..native import loadtxt_unpacked
from . import fhmc_patch as _f

__all__ = ["local_hist", "window", "patch_all_windows", "get_patch_sequence", "tryint"]

tryint = _f.tryint


class local_hist(_f.local_hist):
    """Checkpoint sub-histogram: parses the 'Unnormalized histogram'
    section and normalizes rows on load (chkpt_patch.pyx:85-101)."""

    _HIST_SECTION = "Unnormalized histogram for each"

    def __init__(self, fname):
        try:
            self.load(fname)
            self.normalize()
        except Exception as e:
            raise Exception("Unable to load local histogram from %s : %s" % (fname, e))


class window(_f.window):
    """Checkpoint window: moment matrix normalized by the visit-count row
    (chkpt_patch.pyx:440-449); merge adds volume/order/op asserts
    (:479-484)."""

    def reload(self):
        self.clear()

        with open(self.mom_fname, "r") as f:
            for line in f:
                if line[0] == "#":
                    if "species_total_upper_bound" in line:
                        self.ub = self._op_header(line, "N_{tot}")
                    elif "species_1_upper_bound" in line:
                        self.ub = self._op_header(line, "N_{1}")
                    elif "species_total_lower_bound" in line:
                        self.lb = self._op_header(line, "N_{tot}")
                    elif "species_1_lower_bound" in line:
                        self.lb = self._op_header(line, "N_{1}")
                    elif "volume" in line:
                        self.V = float(line.strip().split(":")[-1])
                    elif "max_order" in line:
                        self.max_order = int(line.strip().split(":")[-1])
                    elif "number_of_species" in line:
                        self.nspec = int(line.strip().split(":")[-1])
                else:
                    break

        self.lnPI = loadtxt_unpacked(self.lnPI_fname)
        mom = loadtxt_unpacked(self.mom_fname)
        # trim OP column and normalize every record by the visit counter
        # (row 1 of the raw matrix, chkpt_patch.pyx:442)
        self.mom = mom[1:] / mom[1]
        assert self.mom.shape[1] == len(self.lnPI), "Inconsistent number of entries in files"
        self.e_hist = local_hist(self.ehist_fname)
        self.pk_hist = [local_hist(self.pkhist_prefix + "_" + str(i + 1) + ".dat") for i in range(self.nspec)]

    def merge(self, other, skip_hist=False):
        assert self.max_order == other.max_order, "Unequal maximum orders between windows, cannot merge"
        assert self.V == other.V, "Unequal volumes between windows, cannot merge"
        assert self.op_name == other.op_name, "Different order parameters between windows, cannot merge"
        return super().merge(other, skip_hist)


def patch_all_windows(fnames, **kwargs):
    """kwargs-style patch over the checkpoint window class
    (chkpt_patch.pyx:683-791); shares _f._drive_patch."""
    out_fname = kwargs.get("out_fname", "composite.nc")
    log_fname = kwargs.get("log_fname", "patch.log")
    offset = kwargs.get("offset", 2)
    smooth = kwargs.get("smooth", False)
    tol = kwargs.get("tol", np.inf)
    skip_hist = kwargs.get("skip_hist", False)
    last_safe_idx = kwargs.get("last_safe_idx", -1)

    histograms = []
    for name_l, name_mom, name_e, name_p in fnames:
        try:
            histograms.append(window(name_l, name_mom, name_e, name_p, offset, smooth))
        except Exception as e:
            raise Exception("Unable to generate patch sequence : %s" % e)

    return _f._drive_patch(
        histograms,
        merge=lambda end, nxt: end.merge(nxt, skip_hist),
        repatch=lambda i: patch_all_windows(
            fnames, out_fname=out_fname, log_fname=log_fname, offset=offset,
            smooth=smooth, tol=tol, skip_hist=skip_hist, last_safe_idx=i,
        ),
        out_fname=out_fname,
        log_fname=log_fname,
        tol=tol,
        last_safe_idx=last_safe_idx,
    )


def get_patch_sequence(idir, **kwargs):
    """Scan <window>/checkpt directories for patchable checkpoint dumps.

    Parity: chkpt_patch.pyx:795-876 — requires state.json with
    crossoverDone, tmmc_lnPI.dat / extMom.dat (every record measured) /
    eHist.dat / pkHist_1.dat; stops at the first incomplete window.
    """
    bound = kwargs.get("bound", 1000000)

    d0 = idir[:-1] if idir.endswith("/") else copy.copy(idir)
    oD = _f._sorted_mixed(tryint(f) for f in os.listdir(d0) if not os.path.isfile(os.path.join(d0, f)))
    only_dirs = [
        d0 + "/" + str(d) + "/checkpt"
        for d in oD
        if tryint(d) <= int(bound) and "checkpt" in os.listdir(d0 + "/" + str(d))
    ]

    lnPI_fname, mom_fname, ehist_fname, pkhist_prefix = [], [], [], []
    for d in only_dirs:
        files = os.listdir(d)
        try:
            with open(d + "/state.json", "r") as fh:
                data = json.load(fh)
        except Exception:
            raise Exception("Checkpoint status file could not be located in : %s" % d)

        if data["crossoverDone"] is True:
            found = {"tmmc": False, "mom": False, "eh": False, "ph": False, "measured": False}
            fn = {"tmmc": "", "mom": "", "eh": "", "ph": ""}
            for f in files:
                if "tmmc_lnPI.dat" in f:
                    found["tmmc"] = True
                    fn["tmmc"] = d + "/" + f
                if "extMom.dat" in f:
                    found["mom"] = True
                    fn["mom"] = d + "/" + f
                    counts = np.loadtxt(fn["mom"], usecols=(1,), unpack=True)
                    if np.all(counts >= 1.0):
                        found["measured"] = True
                if "eHist.dat" in f:
                    found["eh"] = True
                    fn["eh"] = d + "/" + f
                if "pkHist_1.dat" in f:
                    found["ph"] = True
                    fn["ph"] = d + "/pkHist"
            if all(found.values()):
                lnPI_fname.append(fn["tmmc"])
                mom_fname.append(fn["mom"])
                ehist_fname.append(fn["eh"])
                pkhist_prefix.append(fn["ph"])
            else:
                break

    return list(zip(lnPI_fname, mom_fname, ehist_fname, pkhist_prefix))
