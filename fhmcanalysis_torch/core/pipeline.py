"""Batched pipelines over state-point grids.

One call sweeps a whole grid of mu_1 values: reweight, segment, integrate,
where the reference loops point by point (gc_binary.pyx:243-290).  All
outputs are fixed-shape padded tensors + masks; failed state points
surface as valid=False rather than exceptions.
"""

from __future__ import annotations

import torch

from . import cuda_sweep
from .segment import COLLECT_TRANSFORMS, key_rows, thermo_core, thermo_core_props
from .state import Hist, HistMeta

__all__ = ["mu_sweep_thermo", "mu_sweep_body", "most_stable_phase"]

# Points per plain-version chunk, as a budget of B*P*N elements (the plain
# version keeps several [B, P, N]-sized f64 and bool tensors live).
# Measured on one H100 80GB at the n573 / n31 sweep cells: 2**28 peaks at
# 4.9 / 5.7 GiB and runs 7% / 5% faster than 2**26; 2**29 gains 2% more
# for twice the memory, 2**24 is 1.4-1.6x slower (PERF.md).
_PLAIN_CHUNK_ELEMS = 2**28


def _reweight_coeff(h: Hist, mu: torch.Tensor) -> torch.Tensor:
    """a = (mu - mu0) * beta per point, associated as the JAX package's
    pipeline._point_thermo does; the kernel and the plain version both
    form x = lnpi + a * op from this same tensor."""
    return (mu - h.curr_mu[0]) * h.curr_beta


def _point_thermo(h: Hist, meta: HistMeta, mu: torch.Tensor, props: bool, collect=None) -> dict:
    """Fused reweight+thermo for a [B] batch of mu_1 values (plain version).

    lnPI is never normalized: fe and the per-phase averages are invariant
    under lnpi -> lnpi + c, so segmentation runs on the raw reweighted
    surface and integration uses per-phase max-shifted weights.
    """
    x = h.lnpi + _reweight_coeff(h, mu)[:, None] * h.op
    if props:
        pt, pp = thermo_core_props(x, h.mom, meta, h.volume, collect=collect)
    else:
        pt, pp = thermo_core(x, h.mom, meta, props=False, collect=collect), None
    out = {"fe": pt.fe, "mask": pt.mask, "left": pt.left, "right": pt.right, "n_phases": pt.n_phases, "valid": pt.valid}
    if props:
        out.update(pp)
    return out


def mu_sweep_body(h: Hist, meta: HistMeta, mu_grid, props: bool = True, collect=None) -> dict:
    """The plain PyTorch sweep on any device, chunked over points so the
    [B, P, N] intermediates fit in memory."""
    mu = torch.as_tensor(mu_grid, dtype=torch.float64, device=h.device)
    per = max(1, _PLAIN_CHUNK_ELEMS // (meta.max_phases * h.nbins))
    if mu.shape[0] <= per:
        return _point_thermo(h, meta, mu, props, collect)
    outs = [_point_thermo(h, meta, mu[i : i + per], props, collect) for i in range(0, mu.shape[0], per)]
    return {k: torch.cat([o[k] for o in outs]) for k in outs[0]}


def mu_sweep_thermo(h: Hist, meta: HistMeta, mu_grid, props: bool = True, collect=None, engine: str = "auto") -> dict:
    """Reweight + thermo over a 1-D grid of mu_1 values.

    Returns a dict of tensors with leading axis len(mu_grid): per-phase
    padded free energies, bounds, masks and (with props) phase properties
    n_i, x_i [B,P,S] and ntot, u, density [B,P].

    collect: optional segment.COLLECT_TRANSFORMS key ("janus") — the
    batched analog of thermo(collect=...) (gc_hist.pyx:484-486).
    engine: "auto" follows the tensors' device: CUDA launches the fused
    kernel (cuda_sweep), CPU runs the plain version.  "torch" forces the
    plain version on either device; "cuda" forces the kernel and raises
    for CPU tensors.  A kernel failure raises; nothing falls back.
    """
    if engine not in ("auto", "torch", "cuda"):
        raise ValueError(f"engine must be 'auto', 'torch' or 'cuda', got {engine!r}")
    if collect is not None and collect not in COLLECT_TRANSFORMS:
        raise KeyError(collect)
    if engine == "torch" or (engine == "auto" and h.device.type != "cuda"):
        return mu_sweep_body(h, meta, mu_grid, props, collect)
    mu = torch.as_tensor(mu_grid, dtype=torch.float64, device=h.device)
    keys = key_rows(h.mom, meta).contiguous()
    return cuda_sweep.sweep_thermo(
        h.lnpi.contiguous(), h.op.contiguous(), keys, h.volume, _reweight_coeff(h, mu).contiguous(),
        meta.smooth, meta.max_phases, props, collect,
    )


def most_stable_phase(fe, mask):
    """Index of the minimum-free-energy phase among valid slots.

    Parity: _get_most_stable_phase (gc_binary.pyx:83-107).
    """
    return torch.argmin(torch.where(mask, fe, torch.inf), dim=-1)
