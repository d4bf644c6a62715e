"""Entry mb_sweep: ``pipeline.mu_beta_sweep_thermo`` over mu_1 values x
(beta, dMu) targets paired row by row, props on, engine "auto", one call
a request.

Workload keys: M (mu_1 values a call), A (targets), beta and dmu (the
targets' ranges, evenly spaced and paired), order, jitter (as mu_sweep).
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
            "window": inputs.mu_window(cfg["N"], cfg["beta"], cfg["mu0"]), "B": wl["M"] * wl["A"],
            # the targets are the same in every call: on the card once, here
            "betas": torch.linspace(*wl["beta"], wl["A"], dtype=torch.float64, device=device),
            "dmus": torch.linspace(*wl["dmu"], wl["A"], dtype=torch.float64, device=device)[:, None]}


def draw(st: dict, rng) -> dict:
    lo, hi = inputs.jittered(*st["window"], rng, st["wl"]["jitter"])
    return {"lo": lo, "hi": hi}


def make(st: dict, p: dict, dtype=torch.float64):
    mu = torch.linspace(p["lo"], p["hi"], st["wl"]["M"], dtype=torch.float64, device=st["device"])
    return mu.to(dtype), st["betas"].to(dtype), st["dmus"].to(dtype)


def call(st: dict, args) -> dict:
    from fhmcanalysis_torch.core import pipeline

    mu, betas, dmus = args
    out = pipeline.mu_beta_sweep_thermo(st["h"], st["meta"], mu, betas, dmus, order=st["wl"]["order"], props=True, engine="auto")
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
    return sweeps.mb_sweep(h, ref_state.meta(st["cfg"]), *make(st, p, dtype), st["wl"]["order"])


def check(st: dict, p: dict, out: dict) -> dict:
    want = reference(st, p, torch.float64)
    flat = lambda o: {k: v.reshape((st["B"],) + tuple(v.shape[2:])) for k, v in o.items()}  # noqa: E731  [M, A, ...] -> points
    return compare.sweep_numbers(flat(out), flat(want))
