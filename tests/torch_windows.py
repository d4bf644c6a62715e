"""Simulation window trees for the port's win_patch tests and chip_smoke.py.

numpy only and seeded: the machine with the GPU has neither JAX nor h5py,
and the reference's window fixtures are not in the repository.  A tree is
cut from a known composite (``source``: lnpi [N], mom [S, M+1, S, M+1,
M+1, N], op [N], volume, nspec, max_order) by window bounds, so the patch
has an exact answer: the source's lnPI normalized, and its moments.

Three formats, as the front-ends of ``win_patch`` read them:

* ``write_fhmc``: FHMCSimulation, one directory per window, either the
  ``final_*.dat`` files or checkpoint-named ones (``tmmc-Checkpoint-K_lnPI.dat``
  and so on, several K per window, the highest holding the data), over an
  N_tot or an N_1 order parameter; energy and particle-number
  sub-histograms with ragged, tab-separated rows;
* ``write_chkpt``: FHMCSimulation checkpoint dumps (``<window>/checkpt/``
  with ``state.json``, unnormalized records and histograms); the last
  window has not crossed over;
* ``write_feasst``: FEASST ``colMat`` / ``extMom_pr`` per directory, or
  per processor (``colMatp{K}`` / ``extMom_pr_p{K}``) in one directory.

Each window k adds a seeded constant to its lnPI; ``noise`` adds seeded
noise to chosen windows' lnPI (so a patch tolerance triggers a re-patch)
and ``mom_noise`` a seeded relative error to every window's moments (so
the equilibration checks see a spread).  ``WIN800`` is the production
window set of the chip phase, ``patch_in_memory`` the steps of ``_drive_patch``
without a file (the card's machine has no h5py).
"""

from __future__ import annotations

import json
import os
import shutil

import numpy as np

import torch_composites as TC

# The chip phase's cell: a make_composite source at N_tot 0-800, two
# species, moments to order 2 (108 columns), cut into the windows of
# ntot_window_scaling(800, 25, 20, 5) (20 windows, 5-bin overlaps) and
# patched at offset 1; K1 sweeps the patched composite over the window of
# torch_composites.mu_window at the n573 cell's batch.
WIN800 = dict(N=801, nspec=2, max_order=2, smooth=5, max_phases=4, B=524_288, beta=1.0, mu0=(5.0, 0.0), seed=800,
              windows=(800, 25, 20, 5), offset=1)


def checkpoint_sets(n: int) -> list:
    """Checkpoint numbers of n windows for a checkpoint-named tree: two or
    three per window, 10 and 11 among them (natural order, not text order,
    finds the highest)."""
    return [((1, 2, 3), (2, 9, 10), (4, 11))[k % 3] for k in range(n)]


def logsumexp(x):
    m = np.max(x)
    return m + np.log(np.sum(np.exp(x - m)))


def ntot_source(N: int, nspec: int = 2, max_order: int = 2, seed: int = 0, beta: float = 1.0, mu0=(5.0, 0.0)) -> dict:
    """A torch_composites N_tot composite with its lnPI normalized."""
    d = TC.make_composite(N=N, nspec=nspec, beta=beta, mu0=mu0[:nspec], seed=seed, max_order=max_order)
    return dict(d, lnpi=d["lnpi"] - logsumexp(d["lnpi"]), op=np.arange(N), nspec=nspec, max_order=max_order)


def n1_source(N: int, max_order: int = 2, seed: int = 0) -> dict:
    """A two-species composite over the N_1 order parameter: N_1 = op,
    N_2 and U smooth seeded profiles, moments as make_composite forms them."""
    rng = np.random.default_rng(seed)
    n1 = np.arange(N, dtype=np.float64)
    t = n1 / (N - 1)
    c = rng.uniform(-0.1, 0.1, size=3)
    lnpi = 40.0 * np.exp(-(((t - 0.2) / 0.15) ** 2)) + 45.0 * np.exp(-(((t - 0.75) / 0.2) ** 2)) - 5.0 * t
    n2 = 3.0 + (0.5 + c[0]) * n1 + c[1] * np.sin(5.0 * t)
    u = -(n1 + n2) * (0.5 + (1.5 + c[2]) * t)
    mo1 = max_order + 1
    mom = np.zeros((2, mo1, 2, mo1, mo1, N))
    for i in range(2):
        for j in range(mo1):
            for k in range(2):
                for m in range(mo1):
                    for p in range(mo1):
                        a = (j if i == 0 else 0) + (m if k == 0 else 0)
                        b = (j if i == 1 else 0) + (m if k == 1 else 0)
                        mom[i, j, k, m, p] = n1**a * n2**b * u**p * TC._infl(a, b, p)
    return dict(lnpi=lnpi - logsumexp(lnpi), mom=mom, op=np.arange(N), volume=300.0, nspec=2, max_order=max_order)


def cut(source: dict, bounds, seed: int = 0, noise=None, mom_noise: float = 0.0) -> list:
    """Per window (lb, ub) of ``bounds``: a dict of its lb, ub, lnpi (the
    source's plus a seeded constant, plus noise[k] * N(0, 1) per bin where
    ``noise`` names window k), moment records [A, n] (record 0 stays 1;
    the others times 1 + mom_noise * N(0, 1) per window and bin), and the
    source's N_1 and U profiles (the sub-histograms' centres)."""
    rng = np.random.default_rng(seed)
    A = source["mom"][..., 0].size
    mom = source["mom"].reshape(A, -1)
    out = []
    for k, (lb, ub) in enumerate(bounds):
        sl = slice(lb, ub + 1)
        lnpi = source["lnpi"][sl] + rng.uniform(-40.0, 40.0)
        if noise and k in noise:
            lnpi = lnpi + noise[k] * rng.standard_normal(ub - lb + 1)
        m = mom[:, sl].copy()
        if mom_noise:
            m[1:] *= 1.0 + mom_noise * rng.standard_normal((1, ub - lb + 1))
        out.append(dict(lb=lb, ub=ub, lnpi=lnpi, mom=m, n1=source["mom"][0, 1, 0, 0, 0, sl], u=source["mom"][0, 0, 0, 0, 1, sl]))
    return out


def _fmt(values, spec="%.17g", sep="\t"):
    return sep.join(spec % v for v in values)


def _op_key(op_name: str) -> str:
    return "species_total" if op_name == "N_{tot}" else "species_1"


def _lnpi_text(w, op_name):
    key = _op_key(op_name)
    head = "# ln(PI) over the window's %s\n# %s_upper_bound: %d\n# %s_lower_bound: %d\n" % (op_name, key, w["ub"], key, w["lb"])
    return head + "".join("%.17g\n" % v for v in w["lnpi"])


def _mom_text(w, source, op_name, counts=None):
    """The moments file: a description line, nspec and max_order at lines
    2-3 (the equilibration checks read them by position), the bounds and
    the volume; rows N then the A records (times counts, when given, with
    the count itself as record 0: checkpoint dumps)."""
    key = _op_key(op_name)
    head = (
        "# <N_i^j*N_k^m*U^p> as a function of %s\n# number_of_species: %d\n# max_order: %d\n"
        "# %s_upper_bound: %d\n# %s_lower_bound: %d\n# volume: %.17g\n"
        % (op_name, source["nspec"], source["max_order"], key, w["ub"], key, w["lb"], source["volume"])
    )
    m = w["mom"] if counts is None else w["mom"] * counts[None, :]
    rows = ["%d\t%s\n" % (w["lb"] + c, _fmt(m[:, c])) for c in range(m.shape[1])]
    return head + "".join(rows)


def _gauss_row(x, centre, width, skew):
    y = np.exp(-0.5 * ((x - centre) / width) ** 2) + skew * np.exp(-np.abs(x - centre) / (2.0 * width)) + 1e-6
    return y / y.sum()


def _local_hists(w, k, source, op_name, counts=None):
    """(eHist text, [pkHist_i text]) of window k: per bin n of the window
    an energy row over [floor(U) - 3 - k % 3, floor(U) + 2 + k % 2] and,
    per species, a particle-number row over 0..n (n + 1 bins), bin width 1,
    tab-separated; counts make them the checkpoint's unnormalized rows."""
    key = _op_key(op_name)
    section = "Normalized" if counts is None else "Unnormalized"
    head = "# %%s histogram\n# %s_upper_bound: %d\n# %s_lower_bound: %d\n" % (key, w["ub"], key, w["lb"])
    rng = np.random.default_rng(1000 + k)
    n_bins = w["ub"] - w["lb"] + 1
    scale = np.ones(n_bins) if counts is None else counts

    def block(what, lbs, ubs, rows):
        return (
            head % what
            + "# Bin widths for each %s\n" % op_name + _fmt(np.ones(n_bins), "%.1f") + "\n"
            + "# Bin lower bound for each %s\n" % op_name + _fmt(lbs, "%.1f") + "\n"
            + "# Bin upper bound for each %s\n" % op_name + _fmt(ubs, "%.1f") + "\n"
            + "# %s histogram for each %s\n" % (section, op_name)
            + "".join(_fmt(r * s, "%.12g") + "\n" for r, s in zip(rows, scale))
        )

    ctr = np.floor(w["u"])
    elb, eub = ctr - 3 - k % 3, ctr + 2 + k % 2
    erows = [_gauss_row(np.arange(lo, hi + 1), u, 1.5, rng.uniform(0, 0.2)) for lo, hi, u in zip(elb, eub, w["u"])]
    ehist = block("energy", elb, eub, erows)
    ops = np.arange(w["lb"], w["ub"] + 1)
    pk = []
    for i in range(source["nspec"]):
        frac = w["n1"] / np.maximum(ops, 1) if i == 0 else 1.0 - w["n1"] / np.maximum(ops, 1)
        rows = [_gauss_row(np.arange(n + 1, dtype=np.float64), f * n, 1.0 + 0.05 * n, rng.uniform(0, 0.2)) for n, f in zip(ops, frac)]
        pk.append(block("particle number", np.zeros(n_bins), ops.astype(np.float64), rows))
    return ehist, pk


def _write(path, text):
    with open(path, "w") as f:
        f.write(text)


def write_fhmc(root: str, source: dict, bounds, seed: int = 0, op_name: str = "N_{tot}", checkpoints=None, noise=None, mom_noise: float = 0.0) -> list:
    """FHMCSimulation window directories root/1 .. root/W.  checkpoints
    None writes final_*.dat; else checkpoints[k] is the checkpoint numbers
    of window k: the highest holds the window's data, each lower one an
    lnPI shifted by 1 and moments scaled by 1.01 (a patch that picks it
    misses the source), with the top one's sub-histograms."""
    wins = cut(source, bounds, seed, noise, mom_noise)
    for k, w in enumerate(wins):
        d = os.path.join(root, str(k + 1))
        os.makedirs(d, exist_ok=True)
        ehist, pk = _local_hists(w, k, source, op_name)
        if checkpoints is None:
            names = [("final_lnPI.dat", "final_extMom.dat", "final_eHist.dat", "final_pkHist")]
            data = [w]
        else:
            cps = sorted(checkpoints[k])
            names = [("tmmc-Checkpoint-%d_lnPI.dat" % K, "extMom-Checkpoint-%d.dat" % K, "eHist-Checkpoint-%d.dat" % K, "pkHist-Checkpoint-%d" % K) for K in cps]
            stale = dict(w, lnpi=w["lnpi"] + 1.0, mom=np.concatenate([w["mom"][:1], w["mom"][1:] * 1.01]))
            data = [stale] * (len(cps) - 1) + [w]
        for (fl, fm, fe, fp), dw in zip(names, data):
            _write(os.path.join(d, fl), _lnpi_text(dw, op_name))
            _write(os.path.join(d, fm), _mom_text(dw, source, op_name))
            _write(os.path.join(d, fe), ehist)
            for i, text in enumerate(pk):
                _write(os.path.join(d, "%s_%d.dat" % (fp, i + 1)), text)
    return wins


def write_chkpt(root: str, source: dict, bounds, seed: int = 0, noise=None, mom_noise: float = 0.0) -> list:
    """Checkpoint dumps root/k/checkpt/ (state.json, tmmc_lnPI.dat,
    extMom.dat, eHist.dat, pkHist_{i}.dat) with visit counts 2**(4 + n % 5)
    per bin (exact to divide out); the last window has not crossed over."""
    wins = cut(source, bounds, seed, noise, mom_noise)
    for k, w in enumerate(wins):
        d = os.path.join(root, str(k + 1), "checkpt")
        os.makedirs(d, exist_ok=True)
        counts = 2.0 ** (4 + np.arange(w["lb"], w["ub"] + 1) % 5)
        _write(os.path.join(d, "state.json"), json.dumps({"crossoverDone": k < len(wins) - 1}))
        _write(os.path.join(d, "tmmc_lnPI.dat"), _lnpi_text(w, "N_{tot}"))
        _write(os.path.join(d, "extMom.dat"), _mom_text(w, source, "N_{tot}", counts))
        ehist, pk = _local_hists(w, k, source, "N_{tot}", counts)
        _write(os.path.join(d, "eHist.dat"), ehist)
        for i, text in enumerate(pk):
            _write(os.path.join(d, "pkHist_%d.dat" % (i + 1)), text)
    return wins


def _feasst_texts(w, source, order_param="nmol"):
    """(colMat, extMom_pr) of one window: colMat rows "N lnPI 0 0 0";
    extMom_pr rows "opIdx nValues Sum SumSq i j k m p" with i fastest and
    nValues 2**(6 + opIdx % 3), so Sum / nValues is the record exactly."""
    S, mo1 = source["nspec"], source["max_order"] + 1
    n = w["ub"] - w["lb"] + 1
    col = "# colMat\n" + "".join("%d %.17g 0 0 0\n" % (w["lb"] + c, v) for c, v in enumerate(w["lnpi"]))
    head = "# FEASST extMom\n# maxOrder %d\n# nSpec %d\n# orderParam %s\n# volume %.17g\n# nBin %d\n# mMax %.1f\n# mMin %.1f\n" % (
        source["max_order"], S, order_param, source["volume"], n, w["ub"] + 0.5, w["lb"] - 0.5)
    m6 = w["mom"].reshape(S, mo1, S, mo1, mo1, n)
    rows = []
    for c in range(n):
        nval = 2.0 ** (6 + c % 3)
        for p in range(mo1):
            for m in range(mo1):
                for k in range(S):
                    for j in range(mo1):
                        for i in range(S):
                            v = m6[i, j, k, m, p, c]
                            rows.append("%d %.17g %.17g %.17g %d %d %d %d %d\n" % (c, nval, v * nval, v * v * nval, i, j, k, m, p))
    return col, head + "".join(rows)


def write_feasst(root: str, source: dict, bounds, seed: int = 0, multicore: bool = False, order_param: str = "nmol", noise=None, mom_noise: float = 0.0) -> list:
    """FEASST windows: root/k/colMat and root/k/extMom_pr, or with
    multicore root/colMatp{K} and root/extMom_pr_p{K} for K = 0..W, the
    last processor a copy of the last window (the multicore scan keeps
    processors below the last one of each kind)."""
    wins = cut(source, bounds, seed, noise, mom_noise)
    for k, w in enumerate(wins):
        col, ext = _feasst_texts(w, source, order_param)
        if multicore:
            os.makedirs(root, exist_ok=True)
            _write(os.path.join(root, "colMatp%d" % k), col)
            _write(os.path.join(root, "extMom_pr_p%d" % k), ext)
        else:
            d = os.path.join(root, str(k + 1))
            os.makedirs(d, exist_ok=True)
            _write(os.path.join(d, "colMat"), col)
            _write(os.path.join(d, "extMom_pr"), ext)
    if multicore:
        K = len(wins)
        shutil.copyfile(os.path.join(root, "colMatp%d" % (K - 1)), os.path.join(root, "colMatp%d" % K))
        shutil.copyfile(os.path.join(root, "extMom_pr_p%d" % (K - 1)), os.path.join(root, "extMom_pr_p%d" % K))
    return wins


def patch_in_memory(fp, seq, offset=2, smooth=False, skip_hist=False):
    """The steps of ``fp._drive_patch`` through the module's public window
    class, without a file: load every window of ``seq`` (a
    get_patch_sequence list), merge from high to low, normalize, require
    sum(PI) = 1 within 1e-10, and return (``to_composite()``, the window
    with the largest patch error, that error).  ``fp`` is either package's
    fhmc_patch or chkpt_patch; for feasst_patch give ``seq`` as pairs."""
    wins = [fp.window(*s, offset=offset, smooth=smooth) for s in seq]
    wins.sort()
    end = len(wins) - 1
    errs = {}
    for nxt in range(end - 1, -1, -1):
        args = () if len(seq[0]) == 2 else (skip_hist,)  # FEASST windows have no sub-histograms
        _, errs[str(wins[nxt])] = wins[end].merge(wins[nxt], *args)
    worst = max(errs.items(), key=lambda kv: kv[1]) if errs else (str(wins[0]), 0.0)
    wins[end].normalize()
    isum = float(np.exp(logsumexp(wins[end].lnPI)))
    if abs(isum - 1.0) > 1.0e-10:
        raise AssertionError("patched PI sums to %r" % isum)
    return wins[end].to_composite(), worst[0], worst[1]
