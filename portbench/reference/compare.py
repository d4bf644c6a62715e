"""The numbers that decide ``correct``: how far what a timed call returned
lies from what the reference works out for the same inputs."""

from __future__ import annotations

import torch


def mismatch(got: dict, want: dict, fields) -> int:
    """State points (rows of the first axis) at which any of fields differs."""
    bad = None
    for k in fields:
        w = want[k]
        d = (got[k].to(w.device) != w).reshape(w.shape[0], -1).any(-1)
        bad = d if bad is None else bad | d
    return int(bad.sum())


def gap(got: dict, want: dict, fields, where) -> float:
    """The widest relative gap |got - want| / max(|want|, 1) of the float
    fields over the slots where is true (a [B] or [B, P] mask, broadcast
    over trailing axes); equal values, infinities included, read 0."""
    worst = 0.0
    for k in fields:
        w = want[k].double()
        g, where = got[k].to(w.device).double(), where.to(w.device)
        m = where.reshape(where.shape + (1,) * (w.dim() - where.dim()))
        d = torch.where(g == w, 0.0, (g - w).abs() / w.abs().clamp(min=1.0))
        d = torch.where(m, d, 0.0)
        if d.numel():
            worst = max(worst, float(torch.nan_to_num(d, nan=float("inf")).max()))
    return worst


SEG = ("valid", "n_phases", "mask", "left", "right")
PROPS = ("n_i", "x_i", "ntot", "u", "density")


def sweep_numbers(out: dict, want: dict) -> dict:
    """A sweep's numbers, points along the first axis: seg_mismatch, the
    points whose segmentation differs; fe_gap and prop_gap, the widest
    relative gaps over the phases both sides hold alike."""
    v = want["valid"]
    agree = torch.ones_like(v)
    for k in SEG:
        agree &= (out[k].to(v.device) == want[k]).reshape(v.shape[0], -1).all(-1)
    where = want["mask"] & (v & agree)[:, None]
    return {"seg_mismatch": mismatch(out, want, SEG), "fe_gap": gap(out, want, ("fe",), where), "prop_gap": gap(out, want, PROPS, where)}
