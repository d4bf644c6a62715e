"""Histogram state and static metadata.

The reference's ``histogram`` object is a dict of numpy arrays mutated in
place (ntot/gc_hist.pyx:131-182).  Here, as in the JAX package, it is a
frozen dataclass of float64 tensors (`Hist`) and every operation returns a
new one.  All tensors of a `Hist` live on one explicit device: the CUDA
card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Hist:
    """Histogram state on one device.

    Fields mirror gc_hist.pyx data dict:
      lnpi      : f64[N]                    ln(PI) macrostate distribution
      mom       : f64[S, M, S, M, M, N]     N_i^j * N_k^m * U^p moments
      op        : f64[N]                    order parameter (N_tot or N_1)
      curr_mu   : f64[S]                    current chemical potentials
      curr_beta : f64[]                     current 1/kT
      volume    : f64[]                     box volume
    """

    lnpi: torch.Tensor
    mom: torch.Tensor
    op: torch.Tensor
    curr_mu: torch.Tensor
    curr_beta: torch.Tensor
    volume: torch.Tensor

    @property
    def nbins(self) -> int:
        return self.lnpi.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.lnpi.device

    def replace(self, **kw) -> "Hist":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class HistMeta:
    """Static histogram configuration.

    Mirrors the immutable metadata of the reference class
    (ntot/gc_hist.pyx:104-121) plus shape info needed for fixed-shape
    masked segmentation.  Field for field the JAX package's ``HistMeta``.
    """

    nspec: int
    max_order: int
    used_ke: bool = False
    smooth: int = 1
    max_phases: int = 8

    @property
    def mo1(self) -> int:
        return self.max_order + 1

    @property
    def n_addr(self) -> int:
        return self.nspec * self.mo1 * self.nspec * self.mo1 * self.mo1

    def mom_shape(self, nbins: int) -> tuple:
        return (self.nspec, self.mo1, self.nspec, self.mo1, self.mo1, nbins)


def _device(device) -> torch.device:
    """``device`` as a torch.device; None means the CUDA card, and raises
    where there is none rather than carrying on on the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port runs on the card by default; pass device='cpu' to run on the CPU")
    return torch.device("cuda")


def make_hist(lnpi, mom, op, curr_mu, curr_beta, volume, device=None) -> Hist:
    """Build a Hist from host arrays/scalars as f64 tensors on ``device``
    (default: the CUDA card; pass ``device="cpu"`` for the CPU)."""
    device = _device(device)

    def f64(v):
        if torch.is_tensor(v):
            return v.to(dtype=torch.float64, device=device)
        # a writable host copy: the JAX package's to_host arrays are read-only views
        return torch.from_numpy(np.array(v, dtype=np.float64)).to(device)

    return Hist(lnpi=f64(lnpi), mom=f64(mom), op=f64(op), curr_mu=f64(curr_mu), curr_beta=f64(curr_beta), volume=f64(volume))


def to_host(h: Hist) -> dict:
    """Pull a Hist back to host numpy arrays (the JAX ``to_host`` schema)."""
    return {
        "lnpi": h.lnpi.cpu().numpy(),
        "mom": h.mom.cpu().numpy(),
        "op": h.op.cpu().numpy(),
        "curr_mu": h.curr_mu.cpu().numpy(),
        "curr_beta": float(h.curr_beta),
        "volume": float(h.volume),
    }


def from_host(d: dict, device=None) -> Hist:
    """Build a Hist from a ``to_host`` dict of either package, so both
    packages compute from the same state.  ``device`` as for make_hist."""
    return make_hist(d["lnpi"], d["mom"], d["op"], d["curr_mu"], d["curr_beta"], d["volume"], device=device)
