"""Entry iso_grid: ``isopleth(sources, beta_target, order).make_grid(...)``
over a (mu_1, dMu_2) lattice, one call a request, numpy grids back as
users get them.

Set-up builds the configuration's sources (``inputs_iso``: one composite
per dMu_2, kappa from the seed) as the port's histograms on the device and
the isopleth once.  Workload keys: NX, NY (mu_1 columns and dMu_2 rows a
call), mu1 and dmu2 (the windows, each end jittered per call by jitter, a
share of its width, as mu_sweep), engine (make_grid's), check_cells (the
cells of each kept call that the check works out again: one quarter of
the rows in turn, a column anywhere, drawn from the seed).
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import inputs, inputs_iso
from portbench.reference import iso

# the lattice step stretched by this share, so that make_grid's
# ceil(width / delta) + 1 lands on the asked count whatever the rounding
STRETCH = 1e-9


def setup(cfg: dict, wl: dict, seed: int, device) -> dict:
    from fhmcanalysis_torch.binary import isopleth
    from fhmcanalysis_torch.histogram.ntot import histogram

    comps = inputs_iso.sources(cfg, seed)
    hs = [histogram.from_composite(raw, cfg["beta"], [cfg["mu1_ref"], cfg["mu1_ref"] + d], smooth=cfg["smooth"], device=device) for d, raw in comps.items()]
    return {"cfg": cfg, "wl": wl, "device": device, "comps": comps, "iso": isopleth(hs, cfg["beta_target"], order=cfg["order"]), "B": wl["NX"] * wl["NY"]}


def _undefined_row(src: np.ndarray, dmu2: tuple, NY: int) -> bool:
    """Whether a row of the dMu_2 window lies within np.isclose's tolerance
    of a source but not within 1e-9 of it: upstream's find_left_right
    raises there (gc_binary.pyx:31-79), as the program's and the
    reference's do, so the cell keeps out of the band."""
    rows = iso.axis(dmu2, _delta(dmu2, NY))
    return bool((np.isclose(rows[:, None], src[None, :]) & (np.abs(rows[:, None] - src[None, :]) >= iso.TOL)).any())


def draw(st: dict, rng) -> dict:
    """Each window end jittered; a dMu_2 window with a row in upstream's
    undefined band (_undefined_row, ~0.1% of draws) is drawn again."""
    wl = st["wl"]
    NX, NY = wl["NX"], wl["NY"]
    mu1 = inputs.jittered(*wl["mu1"], rng, wl["jitter"])
    src = np.asarray(st["cfg"]["dmu2"], dtype=np.float64)
    dmu2 = inputs.jittered(*wl["dmu2"], rng, wl["jitter"])
    while _undefined_row(src, dmu2, NY):
        dmu2 = inputs.jittered(*wl["dmu2"], rng, wl["jitter"])
    idx = []
    for j in range(wl["check_cells"]):
        q = j % 4
        idx.append(int(rng.integers(q * NY // 4, (q + 1) * NY // 4)) * NX + int(rng.integers(0, NX)))
    return {"mu1": mu1, "dmu2": dmu2, "idx": idx}


def _delta(bounds: tuple, n: int) -> float:
    return (bounds[1] - bounds[0]) / (n - 1) * (1 + STRETCH)


def make(st: dict, p: dict) -> tuple:
    """make_grid's (mu1_bounds, dmu2_bounds, delta) for exactly NX x NY cells."""
    wl = st["wl"]
    return p["mu1"], p["dmu2"], (_delta(p["mu1"], wl["NX"]), _delta(p["dmu2"], wl["NY"]))


def call(st: dict, args) -> dict:
    it = st["iso"]
    it.make_grid(*args, m=st["cfg"]["m"], engine=st["wl"]["engine"])
    return {k: it.data[k] for k in iso.FIELDS}


def work(st: dict, p: dict, out: dict) -> dict:
    """Every cell is attempted; a cell fails where make_grid reports a fail
    code (edge effects, segmentation, saturated slots)."""
    return {"attempted": st["B"], "failed": int(np.count_nonzero(out["fail_code"])), "points": st["B"]}


def keep(st: dict, out: dict) -> dict:
    return {}


def reference(st: dict, p: dict, dtype) -> dict:
    """The reference's outputs at the draw's sampled cells only."""
    mu1_b, dmu2_b, delta = make(st, p)
    mu1, dmu2 = iso.axis(mu1_b, delta[0]), iso.axis(dmu2_b, delta[1])
    NX = len(mu1)
    idx = np.asarray(p["idx"])
    want = iso.cells(st["comps"], st["cfg"], mu1[idx % NX], dmu2[idx // NX], dtype, st["device"])
    want["cells"] = list(p["idx"])
    return want


def check(st: dict, p: dict, out: dict) -> dict:
    """The sampled cells of the call's grids (or, from control.py, the
    reference's own cells) against the reference in float64; grids of
    another shape than NY x NX match no cell."""
    want = reference(st, p, torch.float64)
    if "cells" not in out and np.shape(out["Z"]) != (st["wl"]["NY"], st["wl"]["NX"]):
        return {"seg_mismatch": len(p["idx"]), "fe_gap": float("inf"), "prop_gap": float("inf")}
    got = out if "cells" in out else iso.rows(out, p["idx"])
    return iso.numbers(got, want)
