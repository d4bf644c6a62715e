"""The plain reference of the binary isopleth lattice, and the numbers that
decide ``correct`` for it.

Cell by cell, as gc_binary.pyx's make_grid (:355-476) evaluates a pixel:
the lattice of :386-389 (``np.linspace`` over ceil(width / delta) + 1
values); the two bracketing sources of the row and their weights
(``find_left_right`` :31-79 with bound=True, the weights of :225-240);
each side reweighted to mu_1, its normalised tail held to the edge guard of
gc_hist's extrapolation (lnPI's maximum less cutoff above the last bin)
and Taylor-extrapolated on its own to (beta*, dMu_2) with the semigrand
rows of derivs.py, giving one full surface and key-row set per side; the
two mixed by inverse distance to the power m (gc_hist.mix, as :457-460
call it; a one-source row takes its source's surface unmixed); then
segmentation and integration (segment.py), ``is_safe`` on the mixed
surface's last maximum, and the most stable phase's x_1, density and
F.E./kT.  A failed cell is 0 with a reason code, as the program reports
it: 3 more maxima than the slots, 2 segmentation invalid, 1 an edge guard
failed, 0 ok.

One departure, leaving every output as it was: the grand-canonical
averages of the Taylor step are left out, as in every reference here:
each is one constant over the bins, the mix of two constants is a
constant, and segmentation, the per-phase integrals, the edge guard and
``is_safe`` (differences of two values of one surface) cancel it; for the
same reason the surfaces are not normalised before they are mixed or held
to ``is_safe``.

Plain PyTorch in the dtype given (the control runs float32), batched over
the cells asked for.  Imports nothing of the program.
"""

from __future__ import annotations

import bisect

import numpy as np
import torch

from . import segment, state, sweeps
from .derivs import DerivEngine
from .pore import _gap

TOL = 1.0e-9  # gc_binary.pyx:35, :234
FIELDS = ("Z", "density", "F.E./kT", "valid", "fail_code")
FAIL_OK, FAIL_EDGE_UNSAFE, FAIL_SEGMENTATION, FAIL_PHASE_OVERFLOW = 0, 1, 2, 3

# a float32 matrix product in TF32 would be a third precision
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def axis(bounds, delta: float) -> np.ndarray:
    """One axis of the lattice (gc_binary.pyx:386-389)."""
    lo, hi = float(bounds[0]), float(bounds[1])
    return np.linspace(lo, hi, int(np.ceil((hi - lo) / delta)) + 1)


def bracket(src: np.ndarray, val: float) -> tuple[int, int]:
    """The bracketing sources of dMu_2 = val among the sorted src
    (find_left_right(..., bound=True), gc_binary.pyx:31-79): a value within
    np.isclose's tolerance of a source but not within 1e-9 of it raises, as
    upstream's does."""
    if val <= src[0]:
        return 0, 0
    if val >= src[-1]:
        return len(src) - 1, len(src) - 1
    if np.isclose(val, src).any():
        at = np.nonzero(np.abs(src - val) < TOL)[0]
        if len(at) != 1:
            raise ValueError(f"dmu2 values repeat: {src}, {val}")
        return int(at[0]), int(at[0])
    left = bisect.bisect(list(src), val) - 1
    return left, left + 1


def weights(src: np.ndarray, lr: tuple[int, int], val: float, m: float) -> tuple[float, float]:
    """The complementary distance^m weights of the two sides
    (gc_binary.pyx:225-240): the nearer source weighs more."""
    dl = abs(src[lr[0]] - val) ** m
    dr = abs(src[lr[1]] - val) ** m
    return (1.0, 1.0) if dl + dr < TOL else (dr / (dr + dl), dl / (dr + dl))


def side(h: state.Hist, meta: state.HistMeta, rows, mu1: torch.Tensor, beta_t: float, dmu2: torch.Tensor, order: int, cutoff: float):
    """One source at the cells (mu1[b], dmu2[b]): (x [B, N], key [B, 3, N],
    edge [B]).  Reweighted to each mu_1 (gc_hist.reweight), its normalised
    surface held to the edge guard, then extrapolated to (beta_t, dMu_2)
    (temp_dmu_extrap without the averages): x' and key' in the kernels'
    association (sweeps.py)."""
    xrows, krows = rows
    B = mu1.shape[0]
    a = sweeps.reweight_coeff(h, mu1)
    x = h.lnpi + a[:, None] * h.op
    rw = x - torch.logsumexp(x, dim=-1, keepdim=True)
    edge = (rw.amax(-1) - cutoff) > rw[:, -1]
    tg = sweeps.mb_targets(h, meta, torch.full((B,), beta_t, dtype=x.dtype, device=x.device), dmu2[:, None], order)
    c = lambda j: tg[:, j, None]  # noqa: E731  a cell's target scalar against [B, N]
    x = x + c(0) * (xrows[0] + mu1[:, None] * h.op)
    x = x + c(1) * xrows[1]
    kc = lambda j: tg[:, j, None, None]  # noqa: E731  against [B, 3, N]
    k = krows[0] + kc(0) * krows[1]
    k = k + kc(1) * krows[2]
    if order >= 2:
        q = c(2) * xrows[2]
        q = q + c(3) * xrows[3]
        q = q + c(4) * xrows[4]
        x = x + 0.5 * q
        q = kc(2) * krows[3]
        q = q + kc(3) * krows[4]
        q = q + kc(4) * krows[5]
        k = k + 0.5 * q
    return x, k, edge


def cells(comps: dict, cfg: dict, mu1: np.ndarray, dmu2: np.ndarray, dtype, device="cpu") -> dict:
    """The lattice's outputs at the cells (mu1[b], dmu2[b]): Z (x_1),
    density and F.E./kT of the most stable phase, valid and fail_code, each
    [B] numpy.  comps: {dMu_2: composite} of the sources at beta_ref and
    mu_ref = (0, dMu_2); cfg: the configuration (beta, smooth, max_order,
    max_phases, order, beta_target, m, cutoff)."""
    P, order, cutoff = cfg["max_phases"], cfg["order"], cfg["cutoff"]
    meta = state.HistMeta(2, cfg["max_order"], cfg["smooth"], P)
    src = np.array(sorted(comps))
    hs = [state.hist(dict(comps[d], curr_mu=[0.0, d], curr_beta=cfg["beta"]), device, dtype) for d in src]
    lr = np.array([bracket(src, float(v)) for v in dmu2], dtype=np.int64).reshape(-1, 2)
    w = torch.as_tensor(np.array([weights(src, tuple(p), float(v), cfg["m"]) for p, v in zip(lr.tolist(), dmu2)]).reshape(-1, 2), device=device).to(dtype)
    mu_t = torch.as_tensor(np.asarray(mu1, dtype=np.float64), device=device).to(dtype)
    dmu_t = torch.as_tensor(np.asarray(dmu2, dtype=np.float64), device=device).to(dtype)
    B, N = len(mu1), hs[0].nbins
    xs = [torch.zeros((B, N), dtype=dtype, device=device) for _ in range(2)]
    ks = [torch.zeros((B, 3, N), dtype=dtype, device=device) for _ in range(2)]
    edge = torch.ones(B, dtype=torch.bool, device=device)
    for j in sorted(set(lr.ravel().tolist())):
        h = hs[j]
        rows = sweeps.mb_rows(DerivEngine(h, meta), h, meta, order)
        for s in (0, 1):
            sel = torch.as_tensor(lr[:, s] == j, device=device)
            if bool(sel.any()):
                x, k, e = side(h, meta, rows, mu_t[sel], cfg["beta_target"], dmu_t[sel], order, cutoff)
                xs[s][sel], ks[s][sel] = x, k
                edge[sel] &= e
    one = torch.as_tensor(lr[:, 0] == lr[:, 1], device=device)
    w0, w1 = w[:, 0], w[:, 1]
    xm = torch.where(one[:, None], xs[0], (xs[0] * w0[:, None] + xs[1] * w1[:, None]) / (w0 + w1)[:, None])
    km = torch.where(one[:, None, None], ks[0], (ks[0] * w0[:, None, None] + ks[1] * w1[:, None, None]) / (w0 + w1)[:, None, None])

    volume = torch.as_tensor(float(comps[src[0]]["volume"]), device=device).to(dtype)
    out = segment.thermo_key(xm, km, meta, volume)
    ext = segment.relextrema(xm, meta.smooth, P)
    last = segment._take_small(ext.maxima, ext.n_max - 1)
    safe = (xm.gather(1, last.clamp(0, N - 1).long()[:, None])[:, 0] - xm[:, -1]) >= cutoff  # is_safe (gc_hist.pyx:556-596)
    ok = out["valid"] & safe & edge
    code = torch.where(out["valid"], torch.where(safe & edge, FAIL_OK, FAIL_EDGE_UNSAFE), torch.where(ext.n_max > P, FAIL_PHASE_OVERFLOW, FAIL_SEGMENTATION))
    stable = torch.argmin(torch.where(out["mask"], out["fe"], torch.inf), dim=-1)[:, None]  # _get_most_stable_phase (:83-107)

    def pick(v):
        return torch.where(ok, v.gather(1, stable)[:, 0], 0.0).double().cpu().numpy()

    return {"Z": pick(out["x_i"][..., 0]), "density": pick(out["density"]), "F.E./kT": pick(out["fe"]), "valid": ok.cpu().numpy(),
            "fail_code": code.to(torch.int32).cpu().numpy(), "left": out["left"].cpu().numpy(), "right": out["right"].cpu().numpy(),
            "mask": out["mask"].cpu().numpy()}


def rows(out: dict, idx) -> dict:
    """The cells idx (flat, row-major over [NY, NX]) of a make_grid's
    numpy grids."""
    return {k: np.asarray(out[k]).reshape(-1)[list(idx)] for k in FIELDS}


def numbers(got: dict, want: dict) -> dict:
    """The numbers of cells got against the reference's cells want:
    seg_mismatch, the cells whose valid or fail_code differ; fe_gap, the
    widest relative gap of F.E./kT over the cells both hold valid alike;
    prop_gap, the same over x_1 (Z) and the density."""
    agree = (np.asarray(got["valid"]) == want["valid"]) & (np.asarray(got["fail_code"]) == want["fail_code"])
    live = want["valid"] & agree
    return {"seg_mismatch": int((~agree).sum()), "fe_gap": _gap(got["F.E./kT"], want["F.E./kT"], live),
            "prop_gap": max(_gap(got["Z"], want["Z"], live), _gap(got["density"], want["density"], live))}
