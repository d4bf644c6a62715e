"""Entry pore_sweep: ``two_dim.pore_state_sweep`` over a grid of slit-pore
(p, beta) states, one call a request.

Workload keys: grid (n: n x n states a call, p along a row and beta down
the columns), p and beta (the ranges, each end jittered per call by
jitter, a share of its width, as mu_sweep), segment_engine,
return_surfaces and tie_fallback (passed to the sweep), check_states (the
states of each kept call that the check works out again: one from each
quarter of the grid in turn, drawn from the seed).
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import inputs, inputs_pore
from portbench.reference import pore


def setup(cfg: dict, wl: dict, seed: int, device) -> dict:
    from fhmcanalysis_torch import two_dim

    rows = inputs_pore.rows(cfg["H"], cfg["N"], seed)
    jh = two_dim.joint_hist()
    for r in rows:
        jh.enter(*r)
    jh.make()
    return {"cfg": cfg, "wl": wl, "device": device, "jh": jh, "fh": two_dim.free_energy_profile.polynomial(cfg["fh"]).free_energy,
            "surface": inputs_pore.assemble(rows), "S": wl["grid"] ** 2}


def draw(st: dict, rng) -> dict:
    wl = st["wl"]
    n = wl["grid"]
    half = n // 2
    quarters = [(r, c) for r in (0, half) for c in (0, half)]
    idx = []
    for j in range(wl["check_states"]):
        r, c = quarters[j % 4]
        idx.append(int(rng.integers(r, r + half)) * n + int(rng.integers(c, c + half)))
    return {"p": inputs.jittered(*wl["p"], rng, wl["jitter"]), "beta": inputs.jittered(*wl["beta"], rng, wl["jitter"]), "idx": idx}


def make(st: dict, p: dict) -> tuple[np.ndarray, np.ndarray]:
    n = st["wl"]["grid"]
    pp, bb = np.meshgrid(np.linspace(*p["p"], n), np.linspace(*p["beta"], n))
    return pp.ravel(), bb.ravel()


def call(st: dict, args) -> dict:
    from fhmcanalysis_torch import two_dim

    cfg, wl = st["cfg"], st["wl"]
    out = two_dim.pore_state_sweep(st["jh"], st["fh"], *args, cfg["A"], nnebr=cfg["nnebr"], max_peaks=cfg["max_peaks"], segment_engine=wl["segment_engine"],
                                   return_surfaces=wl["return_surfaces"], tie_fallback=wl["tie_fallback"], device=st["device"])
    if st["device"].type == "cuda":
        torch.cuda.synchronize(st["device"])
    return out


def work(st: dict, p: dict, out: dict) -> dict:
    """Every state is attempted; a state fails where the sweep reports a
    fail code (ridgeline effects, no peak, saturated slots, a tie)."""
    return {"attempted": st["S"], "failed": int(np.count_nonzero(out["fail_code"])), "points": st["S"]}


def keep(st: dict, out: dict) -> dict:
    return {}


def reference(st: dict, p: dict, dtype) -> dict:
    """The reference's rows for the draw's sampled states only (the whole
    grid would take minutes on the host)."""
    pp, bb = make(st, p)
    want = pore.states(st["surface"], st["cfg"], pp[p["idx"]], bb[p["idx"]], dtype)
    want["states"] = list(p["idx"])
    return want


def check(st: dict, p: dict, out: dict) -> dict:
    """The sampled states' rows of the call's output (or, from control.py,
    the reference's own rows) against the reference in float64."""
    got = out if "states" in out else pore.rows(out, p["idx"])
    return pore.numbers(got, reference(st, p, torch.float64))
