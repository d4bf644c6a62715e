"""Log-domain numerics: masked logsumexp, normalization, reweighting.

The reference accumulates ln(sum(exp)) with a sequential pairwise scan in
Cython (spec_exp / _cython_normalize, ntot/gc_hist.pyx:35-67); here it is
one max-shifted reduction.
"""

from __future__ import annotations

import torch


def logsumexp(x: torch.Tensor, dim=-1, where=None, keepdim=False) -> torch.Tensor:
    """Max-shifted logsumexp with optional boolean mask.

    Fully masked slices return -inf (empty sums), matching the reference's
    -DBL_MAX accumulator start (gc_hist.pyx:63).
    """
    if where is not None:
        x = torch.where(where, x, -torch.inf)
    xmax = torch.amax(x, dim=dim, keepdim=True)
    finite = torch.isfinite(xmax)
    xmax_safe = torch.where(finite, xmax, 0.0)
    s = torch.sum(torch.exp(x - xmax_safe), dim=dim, keepdim=True)
    out = torch.where(finite, xmax_safe + torch.log(s), xmax)  # -inf propagates
    if not keepdim:
        out = out.squeeze(dim)
    return out


def normalize_lnpi(lnpi: torch.Tensor) -> torch.Tensor:
    """lnPI -> lnPI - ln(sum(exp(lnPI))), so probabilities sum to 1.

    Parity target: histogram.normalize (ntot/gc_hist.pyx:57-67, 260-266).
    """
    return lnpi - logsumexp(lnpi, dim=-1, keepdim=True)


def reweight_lnpi(lnpi: torch.Tensor, op: torch.Tensor, beta, mu_old, mu_new) -> torch.Tensor:
    """Reweight lnPI to a new mu of species 1 and renormalize.

    lnPI += (mu1' - mu1) * beta * op   (gc_hist.pyx:71-78)
    """
    return normalize_lnpi(lnpi + (mu_new - mu_old) * beta * op)
