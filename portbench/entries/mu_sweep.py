"""Entry mu_sweep: ``pipeline.mu_sweep_thermo`` over a grid of mu_1 values,
props on, engine "auto", one call a request.

Workload keys: points (mu_1 values a call), jitter (how far each end of
the config's one-to-two-phase mu_1 window moves per call, as a share of
its width).
"""

from __future__ import annotations

import torch

from portbench import inputs, roofline
from portbench.reference import compare, state as ref_state, sweeps


def setup(cfg: dict, wl: dict, seed: int, device) -> dict:
    from fhmcanalysis_torch.core import state

    d = inputs.config_composite(cfg, seed)
    meta = state.HistMeta(nspec=cfg["nspec"], max_order=cfg["max_order"], smooth=cfg["smooth"], max_phases=cfg["max_phases"])
    return {"cfg": cfg, "wl": wl, "d": d, "device": device, "h": state.from_host(d, device=device), "meta": meta,
            "window": inputs.mu_window(cfg["N"], cfg["beta"], cfg["mu0"]), "B": wl["points"]}


def draw(st: dict, rng) -> dict:
    lo, hi = inputs.jittered(*st["window"], rng, st["wl"]["jitter"])
    return {"lo": lo, "hi": hi}


def make(st: dict, p: dict, dtype=torch.float64) -> torch.Tensor:
    return torch.linspace(p["lo"], p["hi"], st["B"], dtype=torch.float64, device=st["device"]).to(dtype)


def call(st: dict, mu: torch.Tensor) -> dict:
    from fhmcanalysis_torch.core import pipeline

    out = pipeline.mu_sweep_thermo(st["h"], st["meta"], mu, props=True, engine="auto")
    if mu.is_cuda:
        torch.cuda.synchronize(mu.device)
    return out


def work(st: dict, p: dict, out: dict) -> dict:
    return {"attempted": st["B"], "failed": 0, "points": st["B"]}


def keep(st: dict, out: dict) -> dict:
    """What a traced call's roofline reads: the bins its phase bounds cover."""
    return {"covered": roofline.covered_bins(out["left"], out["right"], out["mask"], st["cfg"]["N"])}


def reference(st: dict, p: dict, dtype) -> dict:
    h = ref_state.hist(st["d"], st["device"], dtype)
    return sweeps.mu_sweep(h, ref_state.meta(st["cfg"]), make(st, p, dtype))


def check(st: dict, p: dict, out: dict) -> dict:
    want = reference(st, p, torch.float64)
    return compare.sweep_numbers(out, want)
