"""The yardstick of the kernels' roofline shares: the card's peaks and the
work a call needs, counted from what the user hands the entry and gets
back, so that moving work between a prologue and a kernel, or splitting
a kernel, leaves the count as it was.

Peaks: NVIDIA's H100 SXM data sheet at 700 W: HBM3 at 3.35 TB/s and
34 TFLOP/s in f64 outside the tensor cores (the kernels do plain f64
arithmetic, built with -fmad=false).  A f64 exp counts as EXP_OPS
operations: CUDA's double exp is a range reduction, a degree-11
polynomial in fused multiply-adds (2 operations each) and a scaling,
about 26 in all.
"""

from __future__ import annotations

import torch

from portbench.reference import derivs, state, sweeps

HBM_BYTES_PER_S = 3.35e12
FP64_OPS_PER_S = 34e12
EXP_OPS = 26
F64, I32, BOOL = 8, 4, 1


def covered_bins(left: torch.Tensor, right: torch.Tensor, mask: torch.Tensor, N: int) -> torch.Tensor:
    """Bins the per-phase sums run over, over all points and phases: the
    max, the exp and the sums cover [left, right) of each real phase,
    clamped to [0, N].  A 0-d tensor on the bounds' device: a traced call
    counts its own without waiting for the device or holding its outputs."""
    return ((right.clamp(0, N) - left.clamp(0, N)).clamp(min=0) * mask).sum()


def tail_ops(B: int, N: int, smooth: int, covered: int, x_ops: int, key_ops: int) -> int:
    """f64 operations of segmentation and integration for B points of N
    bins: forming x (x_ops a bin) and the 4*smooth stencil compares per
    bin and point; per covered bin the phase max, the shift, one exp, the
    weight sum and the key rows (key_ops).  The integer logic of the phase
    walk (O(phases^2) a point) is not counted."""
    return B * N * (x_ops + 4 * smooth) + covered * (3 + EXP_OPS + key_ops)


def k1_ops(S: int) -> tuple[int, int]:
    """(x_ops, key_ops) of the mu sweep: x = lnpi + a op; each key row's
    product and sum."""
    return 2, 2 * (S + 1)


def k2_ops(S: int, order: int) -> tuple[int, int]:
    """(x_ops, key_ops) of the extrapolating sweep: the reweight, the dB
    term, the dd term, the order-2 terms (3 products, 2 sums, the half);
    each key row's Taylor step, then its product and sum."""
    x_ops = 2 + 4 + (2 if S == 2 else 0) + (7 if order == 2 else 0)
    return x_ops, (S + 1) * (2 + 2 + 2 + (7 if order == 2 else 0))


def sweep_out_bytes(B: int, P: int, S: int) -> int:
    """Bytes of the per-point dict a sweep with props returns: fe, mask,
    left, right [B, P]; n_phases, valid [B]; n_i, x_i [B, P, S]; ntot, u,
    density [B, P]."""
    return B * P * (F64 + BOOL + 2 * I32 + 2 * S * F64 + 3 * F64) + B * (I32 + BOOL)


def least_seconds(nbytes: int, ops: int) -> float:
    """The least time the card needs for a call: the larger of its bytes
    over the memory rate and its operations over the f64 peak."""
    return max(nbytes / HBM_BYTES_PER_S, ops / FP64_OPS_PER_S)


def moment_rows(d: dict, cfg: dict, order: int) -> int:
    """The moment rows that the Taylor rows of the given order read, as the
    reference's derivative engine reads them, for a composite d."""
    h, meta = state.hist(d, "cpu"), state.meta(cfg)
    eng = derivs.DerivEngine(h, meta)
    sweeps.mb_rows(eng, h, meta, order)
    return len(eng.read)
