"""A histogram state for the plain reference: the composite's arrays as
tensors of one dtype on one device, and its static sizes."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Hist:
    lnpi: torch.Tensor  # [N]
    mom: torch.Tensor  # [S, M, S, M, M, N] moments N_i^j N_k^m U^p
    op: torch.Tensor  # [N] order parameter N_tot
    curr_mu: torch.Tensor  # [S]
    curr_beta: torch.Tensor  # []
    volume: torch.Tensor  # []

    @property
    def nbins(self) -> int:
        return self.lnpi.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.lnpi.device

    @property
    def dtype(self) -> torch.dtype:
        return self.lnpi.dtype


@dataclasses.dataclass(frozen=True)
class HistMeta:
    nspec: int
    max_order: int
    smooth: int
    max_phases: int
    used_ke: bool = False


def hist(d: dict, device, dtype=torch.float64) -> Hist:
    """A Hist from a composite dict (inputs.make_composite)."""

    def t(v):
        return torch.as_tensor(np.array(v, dtype=np.float64), device=device).to(dtype)

    return Hist(t(d["lnpi"]), t(d["mom"]), t(d["op"]), t(d["curr_mu"]), t(d["curr_beta"]), t(d["volume"]))


def meta(cfg: dict, max_phases: int | None = None) -> HistMeta:
    """The HistMeta of a configuration file's sizes."""
    return HistMeta(cfg["nspec"], cfg["max_order"], cfg["smooth"], cfg["max_phases"] if max_phases is None else max_phases)
