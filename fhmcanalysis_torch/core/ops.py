"""Elementary histogram operations as pure Hist -> Hist functions."""

from __future__ import annotations

import torch

from .numerics import normalize_lnpi
from .state import Hist

__all__ = ["normalize", "reweight", "mix_equal_shape"]


def normalize(h: Hist) -> Hist:
    """Normalize lnPI (gc_hist.pyx:57-67)."""
    return h.replace(lnpi=normalize_lnpi(h.lnpi))


def reweight(h: Hist, mu1_target, rigid_mu: bool = True) -> Hist:
    """Reweight lnPI to a new mu_1 and renormalize (gc_hist.pyx:71-78,
    268-289).

    rigid_mu=True (N_tot engine): curr_mu shifts rigidly by dmu1 for every
    species, preserving dMu.  rigid_mu=False (N_1 engine,
    n1/gc_hist.pyx:259-282): only curr_mu[0] changes.
    """
    mu1_target = torch.as_tensor(mu1_target, dtype=h.lnpi.dtype, device=h.device)
    dmu1 = mu1_target - h.curr_mu[..., 0]
    lnpi = normalize_lnpi(h.lnpi + dmu1[..., None] * h.curr_beta[..., None] * h.op)
    if rigid_mu:
        new_mu = h.curr_mu + dmu1[..., None]
    else:
        new_mu = h.curr_mu.clone()
        new_mu[..., 0] = mu1_target
    return h.replace(lnpi=lnpi, curr_mu=new_mu)


def mix_equal_shape(h1: Hist, h2: Hist, w1, w2) -> Hist:
    """Weighted blend of two same-shape histograms at identical conditions.

    Device-path core of histogram.mix (gc_hist.pyx:184-258); the
    different-length bookkeeping lives in the host wrapper.
    """
    wsum = w1 + w2
    return h1.replace(
        lnpi=(h1.lnpi * w1 + h2.lnpi * w2) / wsum,
        mom=(h1.mom * w1 + h2.mom * w2) / wsum,
    )
