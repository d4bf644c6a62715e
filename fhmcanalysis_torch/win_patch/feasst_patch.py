"""Window patching for FEASST simulator output (colMat / extMom_pr).

Parity target: the reference's moments/win_patch/feasst_patch.pyx —
lnPI from colMat column 2, moments from extMom_pr rows
(opIdx, nValues, Sum, SumSq, i, j, k, m, p -> mom = Sum/nValues,
feasst_patch.pyx:226-235), nmol order parameter asserted, no e/pk
sub-histograms.  FEASST's extMom_pr address order runs i fastest.

The PyTorch port's copy of the JAX package's ``win_patch/feasst_patch.py``: host
numpy, the same arithmetic and side effects; it reads tables through the
port's ``native`` and writes through the port's ``io``.
"""

from __future__ import annotations

import copy
import os

import numpy as np

from ..native import loadtxt_unpacked, read_table
from . import fhmc_patch as _f

__all__ = [
    "window",
    "window_patch_error",
    "patch_window_pair",
    "patch_all_windows",
    "get_patch_sequence",
    "get_patch_sequence_multicore",
    "tryint",
]

tryint = _f.tryint
window_patch_error = _f.window_patch_error


class window(object):
    """One FEASST window: lnPI + moments matrix with exponent table
    (feasst_patch.pyx:82-353)."""

    def __init__(self, colMat_fname="colMat", extMom_fname="extMom_pr", offset=2, smooth=False):
        self.clear()
        self.colMat_fname = colMat_fname
        self.extMom_fname = extMom_fname
        self.offset = offset
        self.smooth = smooth
        assert self.offset >= 0, "Offset must be >= 0"
        self.reload()

    def __repr__(self):
        return self.colMat_fname + "::" + self.extMom_fname + "-[" + str(self.lb) + "," + str(self.ub) + "]"

    def __lt__(self, other):
        return self.lb < other.lb

    def clear(self):
        self.lnPI = np.array([])
        self.max_order = 0
        self.mom = np.array([])
        self.mom_exp = np.array([])
        self.lb = 0
        self.ub = 0
        self.V = 0.0
        self.nspec = 0
        self.op_name = ""

    def normalize(self):
        self.lnPI = self.lnPI - _f._logsumexp(self.lnPI)

    def reload(self):
        """Parse extMom_pr header + rows, colMat lnPI
        (feasst_patch.pyx:171-240)."""
        self.clear()

        nbins = None
        with open(self.extMom_fname, "r") as f:
            for line in f:
                if line[0] == "#":
                    if "maxOrder" in line:
                        self.max_order = int(line.strip().split(" ")[-1])
                    elif "nSpec" in line:
                        self.nspec = int(line.strip().split(" ")[-1])
                    elif "orderParam" in line:
                        op = line.strip().split(" ")[-1]
                        assert op == "nmol", (
                            "FEASST requires total number of molecules as order parameter : %s" % op
                        )
                        self.op_name = "N_{tot}"
                    elif "volume" in line:
                        self.V = float(line.strip().split(" ")[-1])
                    elif "nBin" in line:
                        nbins = int(line.strip().split(" ")[-1])
                    elif "mMax" in line:
                        # FEASST bin = 1 but reports at "midpoint"
                        self.ub = int(np.floor(float(line.strip().split(" ")[-1])))
                    elif "mMin" in line:
                        self.lb = int(np.ceil(float(line.strip().split(" ")[-1])))
                else:
                    break

        assert self.ub - self.lb + 1 == nbins, (
            "Upper and lower bounds do not match number of bins in : %s" % self.extMom_fname
        )

        self.lnPI = loadtxt_unpacked(self.colMat_fname)[1]
        num_moments = self.nspec * (self.max_order + 1) * self.nspec * (self.max_order + 1) * (self.max_order + 1)
        self.mom = np.zeros((num_moments, nbins))
        self.mom_exp = np.zeros((num_moments, 5), dtype=np.int32)

        dummy_mom = read_table(self.extMom_fname)
        for ctr, row in enumerate(dummy_mom):
            opIdx, nValues, Sum, SumSq, i, j, k, m, p = row
            momIdx = ctr % num_moments
            self.mom[momIdx, int(opIdx)] = Sum / nValues
            self.mom_exp[momIdx] = [i, j, k, m, p]

        assert self.mom.shape[1] == len(self.lnPI), "Inconsistent number of entries in files"

    def merge(self, other):
        """Merge a lower window into this one (feasst_patch.pyx:242-295);
        no sub-histograms to blend."""
        assert self.nspec == other.nspec, "Number of components different, cannot merge"
        shift, err2 = patch_window_pair(self, other)
        self.lnPI = self.lnPI + shift

        assert self.max_order == other.max_order, "Unequal maximum orders between windows, cannot merge"
        assert self.V == other.V, "Unequal volumes between windows, cannot merge"
        assert self.op_name == other.op_name, "Different order parameters between windows, cannot merge"
        assert self.lb > other.lb, "Can only patch from high %s to lower" % self.op_name
        assert self.offset == other.offset, "Cannot patch, inconsistent offsets between windows"
        assert self.offset >= 0, "Invalid offset found during merge"
        index = other.ub - self.lb + 1
        self.lb = other.lb

        if self.smooth:
            partA = other.lnPI[: len(other.lnPI) - index + self.offset]
            o_B = other.lnPI[len(other.lnPI) - index + self.offset : len(other.lnPI) - other.offset]
            s_B = self.lnPI[self.offset : index - other.offset]
            o_W = np.arange(len(o_B), 0, -1, dtype=np.float64)
            s_W = np.arange(1, len(s_B) + 1, dtype=np.float64)
            partB = (o_B * o_W + s_B * s_W) / (o_W + s_W)
            partC = self.lnPI[index - other.offset :]
            self.lnPI = np.concatenate([partA, partB, partC])

            partA = other.mom[:, : other.mom.shape[1] - index + self.offset]
            o_B = other.mom[:, other.mom.shape[1] - index + self.offset : other.mom.shape[1] - other.offset]
            s_B = self.mom[:, self.offset : index - other.offset]
            o_W = np.arange(o_B.shape[1], 0, -1, dtype=np.float64)[None, :]
            s_W = np.arange(s_B.shape[1], 0, -1, dtype=np.float64)[None, :]
            partB = (o_B * o_W + s_B * s_W) / (o_W + s_W)
            partC = self.mom[:, index - other.offset :]
            self.mom = np.hstack([partA, partB, partC])
        else:
            self.lnPI = np.concatenate(
                [other.lnPI[: len(other.lnPI) - other.offset], self.lnPI[index - self.offset :]]
            )
            self.mom = np.hstack(
                [other.mom[:, : other.mom.shape[1] - other.offset], self.mom[:, index - self.offset :]]
            )

        return shift, err2

    def to_composite(self):
        """The composite as the dict ``io.read_composite`` returns for the
        file ``to_nc`` writes (no sub-histograms); FEASST rows run i
        fastest, so the 6-D tensor is scattered through the exponent table
        (feasst_patch.pyx:297-351)."""
        n = len(self.lnPI)
        mo1 = self.max_order + 1
        mom6 = np.zeros((self.nspec, mo1, self.nspec, mo1, mo1, n))

        address = 0
        for p in range(mo1):
            for m in range(mo1):
                for k in range(self.nspec):
                    for j in range(mo1):
                        for i in range(self.nspec):
                            ii, jj, kk, mm, pp = self.mom_exp[address]
                            if not (i == ii and j == jj and k == kk and m == mm and p == pp):
                                raise Exception(
                                    "Exponent indices do not match : %s vs %s"
                                    % ([i, j, k, m, p], [ii, jj, kk, mm, pp])
                                )
                            mom6[ii, jj, kk, mm, pp, :] = self.mom[address]
                            address += 1

        return _f._composite(self.lnPI, np.arange(self.lb, self.ub + 1), mom6, self.V, self.nspec, self.max_order)

    def to_nc(self, fname):
        """Write the composite netCDF: ``write_composite`` of
        ``to_composite()``."""
        _f._write(fname, self.to_composite(), self.op_name)


def patch_window_pair(window_hist1, window_hist2, ftol=1.0e-6):
    """Closed-form optimal shift (see fhmc_patch.patch_window_pair);
    slices per feasst_patch.pyx:506-534 (offset may be 0)."""
    assert window_hist1.lb > window_hist2.lb, "Histograms out of order, cannot patch"
    assert window_hist1.ub > window_hist2.ub, "Histograms out of order, cannot patch"
    assert window_hist1.lb < window_hist2.ub, "Histograms do not overlap, cannot patch"

    index = window_hist2.ub - window_hist1.lb + 1
    off = window_hist1.offset
    s1 = window_hist1.lnPI[off : index - off]
    s2 = window_hist2.lnPI[len(window_hist2.lnPI) - index + off : len(window_hist2.lnPI) - off]

    assert len(s1) > 1, "Error, unable to patch windows because there is no overlap"
    assert len(s2) > 1, "Error, unable to patch windows because there is no overlap"

    shift = float(np.mean(np.asarray(s2) - np.asarray(s1)))
    err2 = window_patch_error(shift, s1, s2)
    return shift, err2 / len(s1)


def patch_all_windows(fnames, **kwargs):
    """kwargs-style patch over FEASST windows (feasst_patch.pyx:429-536);
    shares _f._drive_patch."""
    out_fname = kwargs.get("out_fname", "composite.nc")
    log_fname = kwargs.get("log_fname", "patch.log")
    offset = kwargs.get("offset", 2)
    smooth = kwargs.get("smooth", False)
    tol = kwargs.get("tol", np.inf)
    last_safe_idx = kwargs.get("last_safe_idx", -1)

    histograms = []
    for name_l, name_mom in fnames:
        try:
            histograms.append(window(colMat_fname=name_l, extMom_fname=name_mom, offset=offset, smooth=smooth))
        except Exception as e:
            raise Exception("Unable to generate patch sequence : %s" % e)

    return _f._drive_patch(
        histograms,
        merge=lambda end, nxt: end.merge(nxt),
        repatch=lambda i: patch_all_windows(
            fnames, out_fname=out_fname, log_fname=log_fname, offset=offset,
            smooth=smooth, tol=tol, last_safe_idx=i,
        ),
        out_fname=out_fname,
        log_fname=log_fname,
        tol=tol,
        last_safe_idx=last_safe_idx,
    )


def get_patch_sequence(idir, **kwargs):
    """Numbered window dirs containing colMat + extMom_pr
    (feasst_patch.pyx:538-599)."""
    bound = kwargs.get("bound", 1000000)
    colMat_fname = kwargs.get("colMat_fname", "colMat")
    extMom_fname = kwargs.get("extMom_fname", "extMom_pr")

    d0 = idir[:-1] if idir.endswith("/") else copy.copy(idir)
    oD = _f._sorted_mixed(tryint(f) for f in os.listdir(d0) if not os.path.isfile(os.path.join(d0, f)))
    only_dirs = [d0 + "/" + str(d) for d in oD if tryint(d) <= int(bound)]

    lnPI_fname, mom_fname = [], []
    for d in only_dirs:
        files = os.listdir(d)
        found = {"tmmc": False, "mom": False}
        fn = {"tmmc": "", "mom": ""}
        for f in files:
            if colMat_fname in f and ".bak" not in f:
                found["tmmc"] = True
                fn["tmmc"] = d + "/" + f
            if extMom_fname in f and ".bak" not in f:
                found["mom"] = True
                fn["mom"] = d + "/" + f
        if all(found.values()):
            lnPI_fname.append(fn["tmmc"])
            mom_fname.append(fn["mom"])
        else:
            break

    return list(zip(lnPI_fname, mom_fname))


def get_patch_sequence_multicore(idir, **kwargs):
    """Per-processor file naming colMatp{K} in one directory
    (feasst_patch.pyx:601-676)."""
    colMat_pre = kwargs.get("colMat_pre", "colMat")
    colMat_suf = kwargs.get("colMat_suf", "")
    extMom_pre = kwargs.get("extMom_pre", "extMom_pr_")
    extMom_suf = kwargs.get("extMom_suf", "")

    d0 = idir[:-1] if idir.endswith("/") else copy.copy(idir)

    procE = 0
    while os.path.isfile(d0 + "/" + extMom_pre + "p" + str(procE) + extMom_suf):
        procE += 1
    procL = 0
    while os.path.isfile(d0 + "/" + colMat_pre + "p" + str(procL) + colMat_suf):
        procL += 1

    max_safe_proc = min(procL - 1, procE - 1)
    if max_safe_proc < 1:
        raise Exception("No windows found at all")

    lnPI_fname = [d0 + "/" + colMat_pre + "p" + str(p) + colMat_suf for p in range(0, max_safe_proc)]
    mom_fname = [d0 + "/" + extMom_pre + "p" + str(p) + extMom_suf for p in range(0, max_safe_proc)]
    return list(zip(lnPI_fname, mom_fname))
