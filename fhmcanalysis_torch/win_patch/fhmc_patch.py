"""Patch FHMCSimulation window outputs into one composite histogram.

Parity target: the reference's moments/win_patch/fhmc_patch.pyx.  All I/O
and per-bin bookkeeping is host-side numpy (ragged, tiny); the pairwise
lnPI shift that the reference finds with a Nelder-Mead loop
(fhmc_patch.pyx:640-709) has a closed form — the minimizer of
sum((lnPI1 + x) - lnPI2)^2 is x = mean(lnPI2 - lnPI1) — used here
directly (validated against fmin to <1e-6 in the test suite).

The PyTorch port's copy of the JAX package's ``win_patch/fhmc_patch.py``: host
numpy, the same arithmetic and side effects; it reads tables through the
port's ``native`` and writes through the port's ``io``.
"""

from __future__ import annotations

import os
import re
import time

import numpy as np

from ..io import write_composite
from ..native import loadtxt_unpacked

__all__ = [
    "tryint",
    "alphanum_key",
    "sort_nicely",
    "local_hist",
    "window",
    "window_patch_error",
    "patch_window_pair",
    "patch_all_windows",
    "get_patch_sequence",
]


def tryint(s):
    """Integer form of s if possible, else s (fhmc_patch.pyx:29-47)."""
    try:
        return int(s)
    except (TypeError, ValueError):
        return s


def alphanum_key(s):
    """Split string into string/int runs for natural sorting
    (fhmc_patch.pyx:49-65)."""
    return [tryint(c) for c in re.split("([0-9]+)", s)]


def sort_nicely(lst):
    """In-place natural sort (fhmc_patch.pyx:67-83)."""
    lst.sort(key=alphanum_key)


def _sorted_mixed(items):
    """Sort ints before strings, each ascending — the py2 ordering the
    reference relied on (sorted() crashes on mixed types in py3)."""
    return sorted(items, key=lambda v: (isinstance(v, str), v))


def _logsumexp(x):
    x = np.asarray(x, dtype=np.float64)
    m = np.max(x)
    return m + np.log(np.sum(np.exp(x - m)))


class local_hist(object):
    """Per-N sub-histogram (energy or particle number) from a .dat file.

    Parity: fhmc_patch.pyx:121-321 (header-driven section parser, aligned
    per-bin weighted merge).  `_HIST_SECTION` selects the data-section
    header; the chkpt front-end overrides it for unnormalized dumps.
    """

    _HIST_SECTION = "Normalized histogram for each"

    def __init__(self, fname):
        try:
            self.load(fname)
        except Exception as e:
            raise Exception("Unable to load local histogram from %s : %s" % (fname, e))

    def clear(self):
        self.ub = np.array([])
        self.lb = np.array([])
        self.bw = np.array([])
        self.h = []
        self.win_start = 0
        self.win_end = 0

    def load(self, fname):
        self.clear()

        with open(fname, "r") as f:
            for line in f:
                if line[0] == "#":
                    if "species_total_upper_bound" in line or "species_1_upper_bound" in line:
                        self.win_end = int(line.strip().split(":")[-1])
                    elif "species_total_lower_bound" in line or "species_1_lower_bound" in line:
                        self.win_start = int(line.strip().split(":")[-1])
                else:
                    break
        assert self.win_start < self.win_end, "Bounds out of order"

        with open(fname, "r") as f:
            sect = None
            for line in f:
                if line[0] == "#" and sect != "h":
                    if "Bin widths for each" in line:
                        sect = "bw"
                    elif "Bin lower bound for each" in line:
                        sect = "lb"
                    elif "Bin upper bound for each" in line:
                        sect = "ub"
                    elif self._HIST_SECTION in line:
                        sect = "h"
                    else:
                        sect = None
                else:
                    # parse only inside a recognized section; stray lines
                    # are ignored like the reference's else-pass
                    # (fhmc_patch.pyx:189-199)
                    if sect == "bw":
                        self.bw = np.array([float(x) for x in line.split("\t") if x != "\n"])
                    elif sect == "lb":
                        self.lb = np.array([float(x) for x in line.split("\t") if x != "\n"])
                    elif sect == "ub":
                        self.ub = np.array([float(x) for x in line.split("\t") if x != "\n"])
                    elif sect == "h":
                        self.h.append(np.array([float(x) for x in line.split("\t") if x != "\n"]))

        assert len(self.lb) == len(self.ub), "Bad bounds in local_hist"
        assert len(self.lb) == len(self.bw), "Bad bin width in local_hist"

    def merge(self, other, other_weight, skip_hist=False):
        """Merge aligned per-N histograms; self <- blend(self, other).

        Parity: fhmc_patch.pyx:204-308 (alignment asserts, ceil-based bin
        addressing, weight w applied to `other`).
        """
        assert 0 <= other_weight <= 1, "Weight out of range"
        new_start = min(self.win_start, other.win_start)
        new_end = max(self.win_end, other.win_end)
        n_tot = new_end - new_start + 1
        new_bw = np.zeros(n_tot)
        new_lb = np.zeros(n_tot)
        new_ub = np.zeros(n_tot)
        new_h = []

        for n in range(new_start, new_end + 1):
            belong_self = self.win_start <= n <= self.win_end
            belong_other = other.win_start <= n <= other.win_end
            k = n - new_start

            if belong_self and not belong_other:
                s = n - self.win_start
                new_bw[k], new_lb[k], new_ub[k] = self.bw[s], self.lb[s], self.ub[s]
                new_h.append(self.h[s])
                if skip_hist:
                    new_h[-1].fill(1)
            elif belong_other and not belong_self:
                o = n - other.win_start
                new_bw[k], new_lb[k], new_ub[k] = other.bw[o], other.lb[o], other.ub[o]
                new_h.append(other.h[o])
                if skip_hist:
                    new_h[-1].fill(1)
            elif belong_self and belong_other:
                s = n - self.win_start
                o = n - other.win_start
                if skip_hist:
                    new_bw[k] = self.bw[s]
                    new_lb[k] = min(self.lb[s], other.lb[o])
                    new_ub[k] = max(self.ub[s], other.ub[o])
                    tot_bins = int(np.ceil((new_ub[k] - new_lb[k]) / new_bw[k]))
                    if abs(((new_ub[k] - new_lb[k]) / new_bw[k]) - tot_bins) < 1.0e-8:
                        tot_bins += 1  # include endpoint
                    new_h.append(np.ones(tot_bins))
                else:
                    assert abs(self.bw[s] - other.bw[o]) < 1.0e-8, "local_hist objects have different bin widths"
                    x = abs((self.lb[s] - other.lb[o]) / self.bw[s])
                    assert abs(x - np.round(x)) < 1.0e-8, "Bin alignment error"
                    x = abs((self.ub[s] - other.ub[o]) / self.bw[s])
                    assert abs(x - np.round(x)) < 1.0e-8, "Bin alignment error"
                    new_bw[k] = self.bw[s]
                    new_lb[k] = min(self.lb[s], other.lb[o])
                    new_ub[k] = max(self.ub[s], other.ub[o])
                    tot_bins = int(np.ceil((new_ub[k] - new_lb[k]) / new_bw[k]))
                    if abs(((new_ub[k] - new_lb[k]) / new_bw[k]) - tot_bins) < 1.0e-8:
                        tot_bins += 1  # include endpoint

                    # vectorized bin transfer with the reference's ceil
                    # addressing and max-bin rounding
                    xs = np.arange(tot_bins) * new_bw[k] + new_lb[k]

                    def pull(src_lb, src_ub, src_bw, src_h):
                        inside = (xs >= src_lb) & (xs <= src_ub)
                        b = np.ceil((xs - src_lb) / src_bw).astype(int)
                        b = np.where(b == len(src_h), len(src_h) - 1, b)
                        vals = np.zeros(tot_bins)
                        bi = np.clip(b, 0, len(src_h) - 1)
                        vals[inside] = np.asarray(src_h)[bi[inside]]
                        return vals

                    a = pull(self.lb[s], self.ub[s], self.bw[s], self.h[s])
                    b = pull(other.lb[o], other.ub[o], other.bw[o], other.h[o])
                    new_h.append(a * (1.0 - other_weight) + b * other_weight)
            else:
                raise Exception("Bounds error in merging local_hist objects")

        self.ub = new_ub
        self.lb = new_lb
        self.bw = new_bw
        self.h = [np.array(r) for r in new_h]
        self.win_start = new_start
        self.win_end = new_end

    def normalize(self):
        """Normalize each per-N row to sum 1.

        NB: the reference's implementation (fhmc_patch.pyx:310-321)
        assigns to the loop variable and is a no-op; rows are expected to
        arrive normalized.  This version actually normalizes.
        """
        self.h = [np.asarray(row) / np.sum(row) for row in self.h]


class window(object):
    """One WL-TMMC window: lnPI + moments matrix + e/pk sub-histograms.

    Parity: fhmc_patch.pyx:323-634.
    """

    def __init__(self, lnPI_fname, mom_fname, ehist_fname, pkhist_prefix, offset=2, smooth=False):
        self.clear()
        self.lnPI_fname = lnPI_fname
        self.mom_fname = mom_fname
        self.ehist_fname = ehist_fname
        self.pkhist_prefix = pkhist_prefix
        self.offset = offset
        self.smooth = smooth

        assert self.lnPI_fname.endswith(".dat"), "Expects .dat file"
        assert self.mom_fname.endswith(".dat"), "Expects .dat file"
        assert self.ehist_fname.endswith(".dat"), "Expects .dat file"
        assert self.offset >= 1, "Offset must be >= 1"

        self.reload()

    def __repr__(self):
        return (
            self.lnPI_fname + "::" + self.mom_fname + "::" + self.ehist_fname + "::" + self.pkhist_prefix
            + "-[" + str(self.lb) + "," + str(self.ub) + "]"
        )

    def __lt__(self, other):
        return self.lb < other.lb

    def clear(self):
        self.lnPI = np.array([])
        self.max_order = 0
        self.mom = np.array([])
        self.pk_hist = []
        self.e_hist = []
        self.lb = 0
        self.ub = 0
        self.nspec = 0
        self.V = 0
        self.op_name = ""

    def normalize(self):
        self.lnPI = self.lnPI - _logsumexp(self.lnPI)

    def _op_header(self, line, name):
        if self.op_name in ("", name):
            self.op_name = name
        else:
            raise Exception("Order parameter seems to change inside a window")
        return int(line.strip().split(":")[-1])

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
        self.mom = loadtxt_unpacked(self.mom_fname)
        self.mom = self.mom[1:]  # trim order-parameter column
        assert self.mom.shape[1] == len(self.lnPI), "Inconsistent number of entries in files"
        self.e_hist = local_hist(self.ehist_fname)
        self.pk_hist = [local_hist(self.pkhist_prefix + "_" + str(i + 1) + ".dat") for i in range(self.nspec)]

    def merge(self, other, skip_hist=False):
        """Merge a lower-N window into this one (self is modified).

        Parity: fhmc_patch.pyx:481-549, including the reference's moment
        smoothing weights (both weight ramps descend — gc side of the
        blend is NOT position-reversed for moments, fhmc_patch.pyx:525,
        reproduced for parity; lnPI uses the ascending/descending pair).
        """
        assert self.nspec == other.nspec, "Number of components different, cannot merge"
        shift, err2 = patch_window_pair(self, other)
        self.lnPI = self.lnPI + shift

        assert self.lb > other.lb, "Can only patch from high %s to lower" % self.op_name
        assert self.offset == other.offset, "Cannot patch, inconsistent offsets"
        assert self.offset >= 1, "Invalid offset found during merge"
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

            self.e_hist.merge(other.e_hist, 0.5, skip_hist)
            self.e_hist.normalize()
            for i in range(self.nspec):
                self.pk_hist[i].merge(other.pk_hist[i], 0.5, skip_hist)
                self.pk_hist[i].normalize()
        else:
            self.lnPI = np.concatenate(
                [other.lnPI[: len(other.lnPI) - other.offset], self.lnPI[index - self.offset :]]
            )
            self.mom = np.hstack(
                [other.mom[:, : other.mom.shape[1] - other.offset], self.mom[:, index - self.offset :]]
            )
            self.e_hist.merge(other.e_hist, 1.0, skip_hist)
            self.e_hist.normalize()
            for i in range(self.nspec):
                self.pk_hist[i].merge(other.pk_hist[i], 1.0, skip_hist)
                self.pk_hist[i].normalize()

        return shift, err2

    def to_composite(self):
        """The composite as the dict ``io.read_composite`` returns for the
        file ``to_nc`` writes (schema: fhmc_patch.pyx:551-634): lnpi, op,
        mom [nspec, mo1, nspec, mo1, mo1, n], history, volume, nspec,
        max_order, and pk_hist / e_hist with their ragged rows zero-padded
        to the longest.  Needs no h5py: ``histogram.from_composite`` takes
        it as it is."""
        n = len(self.lnPI)
        mo1 = self.max_order + 1
        mom6 = np.asarray(self.mom).reshape(self.nspec, mo1, self.nspec, mo1, mo1, n)

        max_bin = 0
        for row in self.e_hist.h:
            max_bin = max(max_bin, len(row))
        for i in range(self.nspec):
            for row in self.pk_hist[i].h:
                max_bin = max(max_bin, len(row))

        def padded(hists):
            out = np.zeros((len(hists), max_bin))
            for r, row in enumerate(hists):
                out[r, : len(row)] = row
            return out

        pk = {
            "hist": np.stack([padded(self.pk_hist[i].h) for i in range(self.nspec)]),
            "lb": np.stack([self.pk_hist[i].lb for i in range(self.nspec)]),
            "ub": np.stack([self.pk_hist[i].ub for i in range(self.nspec)]),
            "bw": np.stack([self.pk_hist[i].bw for i in range(self.nspec)]),
        }
        eh = {
            "hist": padded(self.e_hist.h),
            "lb": self.e_hist.lb,
            "ub": self.e_hist.ub,
            "bw": self.e_hist.bw,
        }
        return _composite(
            self.lnPI, np.arange(self.lb, self.ub + 1), mom6, self.V, self.nspec, self.max_order, pk_hist=pk, e_hist=eh
        )

    def to_nc(self, fname):
        """Write the composite netCDF4 file: ``write_composite`` of
        ``to_composite()``."""
        _write(fname, self.to_composite(), self.op_name)


def _composite(lnpi, op, mom, volume, nspec, max_order, pk_hist=None, e_hist=None):
    """A composite dict in the types ``io.read_composite`` gives back."""
    out = {
        "history": "Created " + time.ctime(time.time()),
        "volume": float(volume),
        "nspec": int(nspec),
        "max_order": int(max_order),
        "lnpi": np.array(lnpi, dtype=np.float64),
        "op": np.array(op, dtype=np.int64),
        "mom": np.array(mom, dtype=np.float64),
    }
    for key, sub in (("pk_hist", pk_hist), ("e_hist", e_hist)):
        if sub is not None:
            out[key] = {k: np.array(sub[k], dtype=np.float64) for k in ("hist", "lb", "ub", "bw")}
    return out


def _write(fname, c, op_name):
    """``write_composite`` of a composite dict under the order parameter
    ``op_name``."""
    write_composite(
        fname,
        lnpi=c["lnpi"],
        op=c["op"],
        mom=c["mom"],
        volume=c["volume"],
        nspec=c["nspec"],
        max_order=c["max_order"],
        op_name=op_name,
        pk_hist=c.get("pk_hist"),
        e_hist=c.get("e_hist"),
        history=c["history"],
    )


def window_patch_error(x, this_lnPI, other_lnPI):
    """Sum of squared residuals of (this + x) vs other
    (fhmc_patch.pyx:640-664)."""
    return float(np.sum(((np.asarray(this_lnPI) + x) - np.asarray(other_lnPI)) ** 2))


def patch_window_pair(window_hist1, window_hist2, ftol=1.0e-6):
    """Optimal lnPI shift aligning window_hist1 onto window_hist2.

    The quadratic objective's exact minimizer is the mean residual —
    computed in closed form instead of the reference's fmin loop
    (fhmc_patch.pyx:668-709).  Returns (shift, err^2 / n_overlap).
    """
    assert window_hist1.lb > window_hist2.lb, "Histograms out of order, cannot patch"
    assert window_hist1.ub > window_hist2.ub, "Histograms out of order, cannot patch"
    assert window_hist1.lb < window_hist2.ub, "Histograms do not overlap, cannot patch"

    index = window_hist2.ub - window_hist1.lb + 1
    off = window_hist1.offset
    s1 = window_hist1.lnPI[off : index - off]
    s2 = window_hist2.lnPI[len(window_hist2.lnPI) - index + off : len(window_hist2.lnPI) - off]

    assert len(s1) > 1, "Error, unable to patch windows because there is no overlap"
    assert len(s2) > 1, "Error, unable to patch windows because there is no overlap"

    shift = float(np.mean(s2 - s1))
    err2 = window_patch_error(shift, s1, s2)
    return shift, err2 / len(s1)


def _drive_patch(histograms, merge, repatch, out_fname, log_fname, tol, last_safe_idx):
    """Shared patching loop: sort, overlap validation, high-to-low merge
    loop with shift log, tolerance-triggered recursive re-patch, final
    normalization with the 1e-10 sum check, netCDF output.

    Used by the fhmc, chkpt and feasst front-ends (parity: the three
    near-identical loops at fhmc_patch.pyx:713-813, chkpt_patch.pyx:
    683-791, feasst_patch.pyx:429-536); merge(end, nxt) and repatch(i)
    encapsulate the per-format differences.
    """
    end = len(histograms) - 1 if last_safe_idx < 0 else last_safe_idx

    histograms.sort()
    for i in range(0, end):
        if i < len(histograms) - 2:
            if histograms[i].ub <= histograms[i + 1].lb:
                raise Exception(
                    "Histograms from %s and %s do not overlap" % (histograms[i], histograms[i + 1])
                )
            if histograms[i].ub > histograms[i + 2].lb:
                raise Exception(
                    "Histograms from %s, %s, and %s overlap"
                    % (histograms[i], histograms[i + 1], histograms[i + 2])
                )
        else:
            if histograms[i].ub <= histograms[i + 1].lb:
                raise Exception(
                    "Histograms from %s and %s do not overlap" % (histograms[i], histograms[i + 1])
                )

    err_vals = {}
    with open(log_fname, "w") as f:
        nxt = end - 1
        while nxt >= 0:
            lnPIshift, norm_err2 = merge(histograms[end], histograms[nxt])
            err_vals[str(histograms[nxt])] = norm_err2
            f.write(
                "Patching {%s} into {%s} : %s\n" % (histograms[nxt], histograms[end], lnPIshift)
            )
            nxt -= 1

        for i in range(end):
            if err_vals[str(histograms[i])] > tol:
                f.write(
                    "ln(PI) error tolerance exceeded for %s, repatching below this: %s > %s\n"
                    % (histograms[i], err_vals[str(histograms[i])], tol)
                )
                repatch(i)

    if len(histograms) == 1:
        max_err = [str(histograms[0]), 0.0]
    else:
        max_err = max(err_vals.items(), key=lambda kv: kv[1])
    histograms[end].normalize()

    isum = float(np.exp(_logsumexp(histograms[end].lnPI)))
    if abs(isum - 1.0) > 1.0e-10:
        raise Exception(
            "Failed to patch: composite PI sums to %s which differs from 1 by %s" % (isum, abs(isum - 1.0))
        )

    histograms[end].to_nc(out_fname)
    return max_err[0], max_err[1]


def patch_all_windows(
    fnames,
    out_fname="composite.nc",
    log_fname="patch.log",
    offset=2,
    smooth=False,
    tol=np.inf,
    skip_hist=False,
    last_safe_idx=-1,
):
    """Patch a sorted series of windows into one composite histogram.

    Parity: fhmc_patch.pyx:713-813 — see _drive_patch for the shared loop.
    """
    histograms = []
    for name_l, name_mom, name_e, name_p in fnames:
        try:
            histograms.append(window(name_l, name_mom, name_e, name_p, offset, smooth))
        except Exception as e:
            raise Exception("Unable to generate patch sequence : %s" % e)

    return _drive_patch(
        histograms,
        merge=lambda end, nxt: end.merge(nxt, skip_hist),
        repatch=lambda i: patch_all_windows(fnames, out_fname, log_fname, offset, smooth, tol, skip_hist, i),
        out_fname=out_fname,
        log_fname=log_fname,
        tol=tol,
        last_safe_idx=last_safe_idx,
    )


def get_patch_sequence(idir, **kwargs):
    """Scan numbered window directories for the files to patch.

    Parity: fhmc_patch.pyx:817-941 — prefers final_*.dat, else the
    highest common checkpoint across {tmmc, extMom, eHist, pkHist} with a
    min_cp floor; stops at the first incomplete window to preserve order.
    """
    cP = kwargs.get("cP", -1)
    min_cp = kwargs.get("min_cp", 1)
    bound = kwargs.get("bound", 1000000)

    d0 = idir[:-1] if idir.endswith("/") else idir

    oD = _sorted_mixed(tryint(f) for f in os.listdir(d0) if not os.path.isfile(os.path.join(d0, f)))
    only_dirs = [d0 + "/" + str(d) for d in oD if tryint(d) <= int(bound)]

    lnPI_fname, mom_fname, ehist_fname, pkhist_prefix = [], [], [], []

    for d in only_dirs:
        files = os.listdir(d)
        if cP >= 0:
            found = {"tmmc": False, "mom": False, "eh": False, "ph": False}
            fn = {"tmmc": "", "mom": "", "eh": "", "ph": ""}
            for f in files:
                if "tmmc-Checkpoint-%d_lnPI" % cP in f:
                    found["tmmc"] = True
                    fn["tmmc"] = d + "/" + f
                if "extMom-Checkpoint-%d." % cP in f:
                    found["mom"] = True
                    fn["mom"] = d + "/" + f
                if "eHist-Checkpoint-%d." % cP in f:
                    found["eh"] = True
                    fn["eh"] = d + "/" + f
                if "pkHist-Checkpoint-%d_1." % cP in f:  # only look for species 1
                    found["ph"] = True
                    fn["ph"] = d + "/pkHist-Checkpoint-%d" % cP
            if all(found.values()):
                lnPI_fname.append(fn["tmmc"])
                mom_fname.append(fn["mom"])
                ehist_fname.append(fn["eh"])
                pkhist_prefix.append(fn["ph"])
            else:
                break  # do not continue, to avoid getting windows out of order
        else:
            if "final_lnPI.dat" in files:
                lnPI_fname.append(d + "/final_lnPI.dat")
                mom_fname.append(d + "/final_extMom.dat")
                ehist_fname.append(d + "/final_eHist.dat")
                pkhist_prefix.append(d + "/final_pkHist")
            else:
                l, m, p, q = [], [], [], []
                found = {"tmmc": False, "mom": False, "eh": False, "ph": False}
                max_cp = {"tmmc": 0, "mom": 0, "eh": 0, "ph": 0}
                for f in files:
                    if "tmmc-Checkpoint-" in f and "_lnPI.dat" in f:
                        l.append(f)
                        found["tmmc"] = True
                        max_cp["tmmc"] = max(max_cp["tmmc"], int(re.split(r"_|-|\.", f)[2]))
                    if "extMom-Checkpoint-" in f and ".dat" in f:
                        m.append(f)
                        found["mom"] = True
                        max_cp["mom"] = max(max_cp["mom"], int(re.split(r"_|-|\.", f)[2]))
                    if "eHist-Checkpoint-" in f and ".dat" in f:
                        p.append(f)
                        found["eh"] = True
                        max_cp["eh"] = max(max_cp["eh"], int(re.split(r"_|-|\.", f)[2]))
                    if "pkHist-Checkpoint-" in f and "_1.dat" in f:
                        q.append(f)
                        found["ph"] = True
                        max_cp["ph"] = max(max_cp["ph"], int(re.split(r"_|-|\.", f)[2]))
                if all(found.values()) and min(max_cp.values()) >= min_cp:
                    sort_nicely(l)
                    sort_nicely(m)
                    sort_nicely(p)
                    sort_nicely(q)
                    lnPI_fname.append(d + "/" + l[-1])
                    mom_fname.append(d + "/" + m[-1])
                    ehist_fname.append(d + "/" + p[-1])
                    pkhist_prefix.append(d + "/" + q[-1].split("_")[0])
                else:
                    break

    return list(zip(lnPI_fname, mom_fname, ehist_fname, pkhist_prefix))
