"""2-D (h, N_tot) pore and (N_1, N_tot) joint surface engine.

The PyTorch port of the JAX package's ``core/segment2d.py``: masked
fixed-shape forms of the slit-pore histogram operations (the reference's
moments/histogram/two_dim/h_ntot/pore_hist.pyx) -- row-shift surface
build, ragged-region normalization, per-watershed-phase probability
averages, free energies, ridge diagnostics, transition-state boundary
integrals, and a device watershed -- as tensor functions over padded
[H, N] surfaces and masks.  Where the JAX package vmaps one state over a
batch, the ``*_batch`` functions here take the state axis S as the leading
axis of their tensors; the single-state functions keep the JAX arguments
and run the batch form on one state.  Everything runs on the device of
the tensors it is given (the 2-D pipelines put them on the card).

The boundary integrals and the watershed on CUDA tensors are each one
hand-written kernel (core/cuda_b2d.py, csrc/boundary2d.cu;
core/cuda_ws2d.py, csrc/watershed2d.cu); everything else here is plain
PyTorch.  The only host steps of the 2-D path are the reference-exact
priority flood (two_dim/imaging.py with native/imaging.cpp, the
cross-check arm) and the tiny line profiles.  Labels enter as a dense int
tensor; per-phase quantities are [P]-slot masked contractions.  Every
exponential is max-shifted so intermediates stay <= 1.
"""

from __future__ import annotations

import math

import torch

from . import cuda_b2d, cuda_ws2d

__all__ = [
    "valid_mask_2d",
    "build_pore_lnpi",
    "normalize_2d",
    "ln_f_2d",
    "region_thermo_2d",
    "boundary_pair_integrals",
    "pore_phase_core",
    "hillclimb_segment",
    "hillclimb_segment_batch",
    "pore_sweep_fused",
    "joint_sweep_fused",
]

_BIGNEG = -1.7976931348623157e308  # -sys.float_info.max (pore_hist.pyx:40)

# boundary_pair_integrals reduction engine: "onehot" (a masked reduction per
# label pair, the JAX package's default; on CUDA tensors the hand-written
# kernel of core/cuda_b2d.py, which computes its formulas) or "segment"
# (scatter_reduce by pair key, the cross-check arm).  They form other
# shifted terms, so they agree up to rounding; tests hold them to 1e-12.
BOUNDARY_SEGMENT_ENGINE = "onehot"

_HW = (-2, -1)  # the surface axes of a [..., H, N] tensor


def _t(x, like: torch.Tensor | None = None, dtype=None) -> torch.Tensor:
    """x as a tensor on ``like``'s device (numpy, lists and scalars are
    copied there; a tensor keeps its device unless ``like`` is given)."""
    dev = like.device if like is not None else None
    if torch.is_tensor(x):
        return x.to(device=dev if dev is not None else x.device, dtype=dtype or x.dtype)
    return torch.as_tensor(x, dtype=dtype, device=dev)


def _masked_max(x, mask, dims=_HW, keepdim=False):
    return torch.where(mask, x, -math.inf).amax(dims, keepdim=keepdim)


def _masked_logsumexp(x, mask, dims=_HW, keepdim=False):
    """logsumexp over ``mask`` cells; -inf entries inside the mask are
    legal (exp underflows to exactly 0, matching the host concatenation
    in pore_hist.normalize / _cy_normalize pore_hist.pyx:57-80)."""
    m = _masked_max(x, mask, dims, keepdim=True)
    s = torch.where(mask, torch.exp(x - m), 0.0).sum(dims, keepdim=True)
    out = m + torch.log(s)
    return out if keepdim else out.squeeze(dims)


def valid_mask_2d(edge_idx, n_cols: int):
    """bool[H, N] marking the ragged valid region col <= edge_idx[row]
    (the normalization domain of _cy_normalize, pore_hist.pyx:57-80)."""
    edge = _t(edge_idx)
    cols = torch.arange(n_cols, device=edge.device)
    return cols[None, :] <= edge[:, None]


def build_pore_lnpi(lnpi_raw, h_vals, fh_vals, p, A, beta):
    """Row-shifted lnPI(h, N) surface (pore_hist.pyx:131-135).

    shift[h] = -beta * (F(h) + p*A*h) - lnPI_raw[h, 0]; F(h) enters as a
    precomputed vector (the reference's Python callable is host-only).
    p and beta are scalars, or [S] tensors for S surfaces [S, H, N].
    """
    lnpi_raw = _t(lnpi_raw, dtype=torch.float64)
    h = _t(h_vals, lnpi_raw, torch.float64)
    fh = _t(fh_vals, lnpi_raw, torch.float64)
    if torch.is_tensor(p) or torch.is_tensor(beta):
        p, beta = (_t(v, lnpi_raw, torch.float64) for v in (p, beta))
        p, beta = (v[..., None] if v.dim() else v for v in (p, beta))
    shift = -beta * (fh + p * A * h) - lnpi_raw[:, 0]
    return lnpi_raw + shift[..., :, None]


def normalize_2d(lnpi, valid):
    """Masked 2-D normalization over the ragged valid region
    (pore_hist.pyx:57-80, 146-152), per surface of a [..., H, N] stack."""
    return lnpi - _masked_logsumexp(lnpi, valid, keepdim=True)


def ln_f_2d(lnpi):
    """ln of the empty-pore partition slice, logsumexp over lnPI(h, 0)
    (pore_hist.pyx:205: ln_f from the N=0 column), per surface."""
    col = lnpi[..., :, 0]
    return _masked_logsumexp(col, torch.ones_like(col, dtype=torch.bool), dims=-1)


def region_thermo_2d(lnpi, region, props):
    """Probability-averaged properties over one masked region
    (pore_hist.thermo, pore_hist.pyx:154-184).

    props: f64[K, H, N] stacked property surfaces.  Returns
    (ave[K], lp[H, N]) where lp is the region-renormalized log
    distribution (-inf outside) the host API derives peak_idx from.
    """
    m = _masked_max(lnpi, region)
    lse = _masked_logsumexp(lnpi - m, region)
    lp = torch.where(region, lnpi - m - lse, -math.inf)
    prob = torch.where(region, torch.exp(lp), 0.0)
    sum_prob = prob.sum()
    ave = (prob[None, :, :] * props).sum(_HW) / sum_prob
    return ave, lp


def _boundary_mask(lab, background=0):
    """Inner-mode connectivity-1 boundary pixels (imaging.find_boundaries
    as used at pore_hist.pyx:430) of [S, H, N] labels: a non-background
    pixel adjacent (4-connectivity, edge-padded) to ANY differing label."""
    out = torch.zeros(lab.shape, dtype=torch.bool, device=lab.device)
    out[..., 1:, :] |= lab[..., 1:, :] != lab[..., :-1, :]
    out[..., :-1, :] |= lab[..., :-1, :] != lab[..., 1:, :]
    out[..., :, 1:] |= lab[..., :, 1:] != lab[..., :, :-1]
    out[..., :, :-1] |= lab[..., :, :-1] != lab[..., :, 1:]
    return out & (lab != background)


_NEBR8 = ((1, 1), (1, 0), (1, -1), (0, -1), (-1, -1), (-1, 0), (-1, 1), (0, 1))


def _shifted(x, di: int, dj: int, fill):
    """x[..., r + di, c + dj] at each (r, c) of a [..., H, N] tensor, with
    ``fill`` where the neighbor lies outside the surface."""
    H, N = x.shape[-2:]
    out = torch.full_like(x, fill)
    out[..., max(0, -di) : H - max(0, di), max(0, -dj) : N - max(0, dj)] = x[..., max(0, di) : H + min(0, di), max(0, dj) : N + min(0, dj)]
    return out


def _boundary_batch(lnpi, lab, max_labels: int, engine: str):
    """boundary_pair_integrals over [S, H, N] surfaces and labels: engine
    "onehot" on CUDA tensors launches the hand-written kernel
    (cuda_b2d.boundary_pairs, the one-hot engine's formulas), which raises
    rather than fall back; everything else runs _boundary_plain."""
    if engine == "onehot" and lnpi.is_cuda:
        return cuda_b2d.boundary_pairs(lnpi.contiguous(), lab.contiguous(), max_labels)
    return _boundary_plain(lnpi, lab, max_labels, engine)


def _boundary_plain(lnpi, lab, max_labels: int, engine: str):
    """The plain PyTorch engines of boundary_pair_integrals over [S, H, N]
    surfaces and labels, on any device: "onehot" or "segment"."""
    S = lnpi.shape[0]
    L1 = max_labels + 1
    bnd = _boundary_mask(lab)
    lab_ok = bnd & (lab > 0)
    # per direction: the pair key a*L1 + b (a < b, both live labels, 0 where
    # the cell and its neighbor are no boundary pair) and the neighbor's lnPI
    KEY = torch.empty((8,) + lab.shape, dtype=torch.int64, device=lab.device)  # [8, S, H, N]
    LQ = torch.empty((8,) + lnpi.shape, dtype=lnpi.dtype, device=lnpi.device)
    for d, (di, dj) in enumerate(_NEBR8):
        q_lab = _shifted(lab, di, dj, 0)  # out of bounds reads background: no pair
        ok = lab_ok & (q_lab > 0) & (q_lab != lab)
        KEY[d] = torch.where(ok, torch.minimum(lab, q_lab).long() * L1 + torch.maximum(lab, q_lab), 0)
        LQ[d] = _shifted(lnpi, di, dj, -math.inf)
    LP = lnpi[None]  # the cell's own lnPI, the same for every direction
    bigneg = torch.full((S, L1 * L1), _BIGNEG, dtype=lnpi.dtype, device=lnpi.device)

    if engine == "onehot":
        # per-pair logsumexp in the LINEAR domain: exp(logaddexp(a, b) - ln2
        # - M) == (exp(a - M) + exp(b - M)) / 2, with the shift M the pair's
        # max over max(a, b), so every intermediate is <= 1 at the pair's
        # own saddle: two exps per direction-cell, two logs per pair
        pairs = [pa * L1 + pb for pa in range(1, L1) for pb in range(pa + 1, L1)]
        mx_cell = torch.maximum(LP, LQ)
        Mf = torch.zeros(S, L1 * L1 + 1, dtype=lnpi.dtype, device=lnpi.device)
        for code in pairs:
            M = torch.where(KEY == code, mx_cell, -math.inf).amax((0, 2, 3))
            Mf[:, code] = torch.where(torch.isfinite(M), M, 0.0)
        del mx_cell
        # each direction-cell's own pair shift (0 off the boundary)
        m_elem = Mf[torch.arange(S, device=lnpi.device)[None, :, None, None], KEY]
        E = 0.5 * (torch.exp(LP - m_elem) + torch.exp(LQ - m_elem))
        del m_elem, LQ
        min_df, max_val = bigneg.clone(), bigneg.clone()
        for code in pairs:
            w = torch.where(KEY == code, E, 0.0)
            Sg, X = w.sum((0, 2, 3)), w.amax((0, 2, 3))
            min_df[:, code] = torch.where(Sg > 0.0, Mf[:, code] + torch.log(Sg), _BIGNEG)
            max_val[:, code] = torch.where(X > 0.0, Mf[:, code] + torch.log(X), _BIGNEG)
    elif engine == "segment":
        # two-pass segment logsumexp by pair key: max-shift per pair, then
        # the sum of exp; invalid direction-cells go to an overflow slot
        nseg = L1 * L1 + 1
        keys = torch.where(KEY > 0, KEY, L1 * L1).permute(1, 0, 2, 3).reshape(S, -1)
        ln2 = math.log(2.0)
        vals = torch.where(KEY > 0, torch.logaddexp(LP - ln2, LQ - ln2), -math.inf).permute(1, 0, 2, 3).reshape(S, -1)
        live = keys < L1 * L1
        seg_max = torch.full((S, nseg), -math.inf, dtype=lnpi.dtype, device=lnpi.device).scatter_reduce(1, keys, vals, "amax")
        seg_max_f = torch.where(torch.isfinite(seg_max), seg_max, 0.0)
        shifted = torch.where(live, torch.exp(vals - torch.gather(seg_max_f, 1, keys)), 0.0)
        seg_sum = torch.zeros(S, nseg, dtype=lnpi.dtype, device=lnpi.device).scatter_add(1, keys, shifted)
        min_df = torch.where(seg_sum > 0.0, seg_max_f + torch.log(seg_sum), _BIGNEG)[:, : L1 * L1]
        max_val = torch.where(torch.isfinite(seg_max), seg_max, _BIGNEG)[:, : L1 * L1]
    else:
        raise ValueError(f"unknown boundary engine {engine!r} (expected 'onehot' or 'segment')")

    # symmetrize (each unordered pair was accumulated into the canonical
    # (min, max) slot only) and clear the diagonal
    min_df, max_val = min_df.reshape(S, L1, L1), max_val.reshape(S, L1, L1)
    upper = torch.ones(L1, L1, dtype=torch.bool, device=lnpi.device).triu(1)
    diag = torch.eye(L1, dtype=torch.bool, device=lnpi.device)
    min_df = torch.where(diag, _BIGNEG, torch.where(upper, min_df, min_df.transpose(-1, -2)))
    max_val = torch.where(diag, _BIGNEG, torch.where(upper, max_val, max_val.transpose(-1, -2)))
    return min_df, max_val


def boundary_pair_integrals(lnpi, labels, max_labels: int, engine: str | None = None):
    """Transition-state boundary integrals between watershed phases
    (pore_hist._segment, pore_hist.pyx:425-445).

    For every ordered pair (p -> q) where p is an inner boundary pixel
    with label a > 0 and q one of its 8 in-bounds neighbors with label
    b > 0, b != a, the contribution is
        v = logaddexp(lnPI[p] - ln 2, lnPI[q] - ln 2).
    The host loop's symmetric running update
        min_df[a,b] = logaddexp(min_df[a,b], v); min_df[b,a] = min_df[a,b]
    makes the final entry the logsumexp over contributions in EITHER
    direction, and max_val the max over either direction -- computed here
    as a per-unordered-pair reduction, no host loop.

    lnpi, labels: [H, N], or [S, H, N] for S surfaces.  Returns (min_df,
    max_val): f64[(L+1), (L+1)] (a leading S where the inputs have one)
    with _BIGNEG at pairs with no shared boundary (the reference's
    -sys.float_info.max fill).  ``engine``: None = BOUNDARY_SEGMENT_ENGINE;
    "onehot" on CUDA tensors is the kernel of core/cuda_b2d.py.
    """
    lnpi = _t(lnpi, dtype=torch.float64)
    lab = _t(labels, lnpi, torch.int32)
    one = lnpi.dim() == 2
    out = _boundary_batch(lnpi[None] if one else lnpi, lab[None] if one else lab, max_labels, engine or BOUNDARY_SEGMENT_ENGINE)
    return tuple(t[0] for t in out) if one else out


def pore_phase_batch(lnpi_b, labels_b, valid, edge_idx, props, peak_lnpi_b, n_labels_b, max_phases: int, boundary_engine: str | None = None):
    """Fused per-phase analysis of S normalized surfaces
    (pore_hist.phase_average, pore_hist.pyx:186-252) over [P]-slot masked
    contractions; the state axis S leads every input and output.

    Inputs
    ------
    lnpi_b      : f64[S, H, N]  normalized surfaces
    labels_b    : i32[S, H, N]  watershed phase labels (0 = background)
    valid       : bool[H, N]    ragged valid region (valid_mask_2d)
    edge_idx    : i64[H]        per-row ragged edge column
    props       : f64[K, H, N]  stacked property surfaces
    peak_lnpi_b : f64[S, P]     lnPI at each phase's local maximum, slot-padded
    n_labels_b  : int[S]        live watershed phases per state
    max_phases  : P             slot count

    Returns a dict of slot-padded tensors:
      ave        f64[S, P, K]  probability-averaged properties per phase
      fe         f64[S, P]     F.E./kT = ln_f - lse(lnPI | phase)
      ridge_diff f64[S, P]     max(lnPI|phase) - max(ridge values|phase)
                               (< 10 means ridgeline effects, pyx:230-234)
      peak_flat  i64[S, P]     flat argmax of the phase region (0 on a dead slot)
      act_kT     f64[S, P, P]  activation free energies (pyx:213-227)
      act_kT_diff f64[S, P, P]
      ts         f64[S, P+1, P+1] transition states in -kT units
      phase_ok   bool[S, P]    slot is a live phase
    """
    lnpi = _t(lnpi_b, dtype=torch.float64)
    dev = lnpi.device
    lab = _t(labels_b, lnpi, torch.int32)
    props = _t(props, lnpi, torch.float64)
    edge_idx = _t(edge_idx, lnpi, torch.int64)
    peak_lnpi = _t(peak_lnpi_b, lnpi, torch.float64)
    n_labels = _t(n_labels_b, lnpi)
    S, H, N = lnpi.shape
    P = max_phases
    slots = torch.arange(1, P + 1, device=dev, dtype=torch.int32)
    region = lab[:, None] == slots[None, :, None, None]  # [S, P, H, N]
    phase_ok = slots[None, :] <= n_labels[:, None]

    lnf = ln_f_2d(lnpi)  # [S]

    # per-phase masked probability averages.  Cells partition over phases,
    # so ONE exp per cell suffices: each cell's own phase shift, then one
    # exp -- bitwise identical to exp(lnpi - m[p]) inside region p
    in_region = torch.where(region, lnpi[:, None], -math.inf)
    m = in_region.amax(_HW)  # [S, P]
    m_f = torch.where(torch.isfinite(m), m, 0.0)
    m_cell = torch.where(region, m_f[..., None, None], 0.0).sum(1)  # [S, H, N]
    z = torch.where(region, torch.exp(lnpi - m_cell)[:, None], 0.0)  # [S, P, H, N]
    s = z.sum(_HW)
    prob = z / torch.where(s > 0, s, 1.0)[..., None, None]
    sum_prob = prob.sum(_HW)
    ave = torch.einsum("sphn,khn->spk", prob, props) / torch.where(sum_prob > 0, sum_prob, 1.0)[..., None]

    # F.E./kT per phase (pyx:212: ln_f - lse over the phase mask)
    fe = lnf[:, None] - (m_f + torch.log(torch.where(s > 0, s, 1.0)))
    fe = torch.where(phase_ok, fe, 0.0)

    # ridgeline diagnostic (intended form of pyx:230-234): per-phase max
    # minus the max lnPI along the ragged edge cells owned by the phase
    edge_onehot = torch.arange(N, device=dev)[None, :] == edge_idx[:, None]  # [H, N]
    edge_lnpi = torch.where(edge_onehot, lnpi, -math.inf).amax(-1)  # [S, H]
    edge_lab = torch.where(edge_onehot, lab, -1).amax(-1)  # [S, H]
    ridge = torch.where(edge_lab[:, None, :] == slots[None, :, None], edge_lnpi[:, None, :], -math.inf)  # [S, P, H]
    ridge_diff = m - ridge.amax(-1)  # inf when the phase never touches the edge

    # torch.argmax returns the first maximal index, as jnp.argmax: 0 on an
    # all -inf dead slot
    peak_flat = in_region.reshape(S, P, H * N).argmax(-1)
    del in_region, z, prob

    # transition states (pyx:205-210): ts live entries -> -(ts - ln_f)
    min_df, max_border = _boundary_batch(lnpi, lab, P, boundary_engine or BOUNDARY_SEGMENT_ENGINE)
    live = min_df > _BIGNEG
    ts = torch.where(live, -(min_df - lnf[:, None, None]), min_df)

    # activation matrices (pyx:213-227), phase slots 0..P-1 <-> labels 1..P
    live_pp = live[:, 1:, 1:]
    fe_pair_max = torch.maximum(fe[:, :, None], fe[:, None, :])
    act_kT = torch.where(live_pp, ts[:, 1:, 1:] - fe_pair_max, 0.0)
    peak_pair_min = torch.minimum(peak_lnpi[:, :, None], peak_lnpi[:, None, :])
    act_kT_diff = torch.where(live_pp, peak_pair_min - max_border[:, 1:, 1:], 0.0)
    pair_ok = phase_ok[:, :, None] & phase_ok[:, None, :]
    act_kT = torch.where(pair_ok, act_kT, 0.0)
    act_kT_diff = torch.where(pair_ok, act_kT_diff, 0.0)

    return {
        "ave": ave,
        "fe": fe,
        "ridge_diff": ridge_diff,
        "peak_flat": peak_flat,
        "act_kT": act_kT,
        "act_kT_diff": act_kT_diff,
        "ts": ts,
        "phase_ok": phase_ok,
    }


def pore_phase_core(lnpi, labels, valid, edge_idx, props, peak_lnpi, n_labels, max_phases: int, boundary_engine: str | None = None):
    """Fused per-phase analysis of one normalized pore surface
    (pore_hist.phase_average, pore_hist.pyx:186-252): pore_phase_batch on
    one state.  lnpi, labels [H, N]; peak_lnpi [P]; n_labels a scalar.
    Returns the pore_phase_batch dict without its state axis."""
    lnpi = _t(lnpi, dtype=torch.float64)
    out = pore_phase_batch(
        lnpi[None], _t(labels, lnpi)[None], valid, edge_idx, props, _t(peak_lnpi, lnpi, torch.float64)[None],
        _t(n_labels, lnpi).reshape(1), max_phases, boundary_engine,
    )
    return {k: v[0] for k, v in out.items()}


# ---------------------------------------------------------------------------
# Device watershed: fixed-shape steepest-ascent segmentation
# ---------------------------------------------------------------------------
#
# The reference (and the host arm) segments each surface with a
# priority-flood watershed seeded at the footprint local maxima
# (pore_hist.pyx:377-477; two_dim/imaging.py + native/imaging.cpp).  The
# flood is data-dependent, but its RESULT is not: when every elevation is
# distinct and the markers are exactly the footprint-local maxima -- the
# pore/joint pipelines' own seeding rule -- the flood assigns each cell the
# label of its steepest-ascent chain.  Pops leave the heap in decreasing
# elevation among pushed cells, and a cell's highest neighbor is always
# pushed (via its own ascending chain) before any lower neighbor can pop,
# so every cell is claimed by its argmax neighbor; induction up the chain
# reaches the marker.  That steepest-ascent form is a fixed-shape tensor
# program: a masked footprint argmax per cell, then the chains resolved by
# pointer jumping.  Exact ties (plateaus) are resolved by flood insertion
# order on the host and by lowest flat index here, so plateau boundaries
# may differ; elev_tie flags them, and the host flood stays available as
# the cross-check arm (segment_engine="host").
#
# The JAX package follows the chains with a while_loop of footprint selects
# for footprints of up to 40 cells (TPU gathers are slow) and by pointer
# jumping above that.  Here every footprint uses pointer jumping:
# ceil(log2(H*N)) rounds of torch.gather over [S, H*N] and no host sync.
# Along a chain the (value, -flat index) key rises strictly until a fixed
# point (a peak, or a cell with no finite neighbor), so the chains are
# acyclic and both forms give every cell the marker of its chain's end.
# On CUDA tensors whose shape its rule takes, the hand-written kernel of
# core/cuda_ws2d.py computes the same outputs bit for bit in one launch.


def hillclimb_segment_batch(lnpi_b, valid, fp_shape, max_peaks_slots: int):
    """Watershed labels of S surfaces [S, H, N] as a fixed-shape device
    program: hillclimb_segment with the state axis leading every output.
    CUDA tensors with one [H, N] mask for every state launch the kernel of
    core/cuda_ws2d.py where its rule takes the shape (cuda_ws2d.takes);
    everything else runs _hillclimb_plain."""
    lnpi = _t(lnpi_b, dtype=torch.float64)
    valid = _t(valid, lnpi, torch.bool)
    S, H, N = lnpi.shape
    if lnpi.is_cuda and S and valid.shape == (H, N) and cuda_ws2d.takes(H, N, fp_shape, max_peaks_slots):
        return cuda_ws2d.watershed(lnpi.contiguous(), valid.contiguous(), fp_shape, max_peaks_slots)
    return _hillclimb_plain(lnpi, valid, fp_shape, max_peaks_slots)


def _hillclimb_plain(lnpi, valid, fp_shape, max_peaks_slots: int):
    """hillclimb_segment_batch in plain PyTorch on any device: f64[S, H, N]
    surfaces, a bool mask that broadcasts to them."""
    dev = lnpi.device
    S, H, N = lnpi.shape
    HN = H * N
    P = max_peaks_slots
    ry, rx = (int(fp_shape[0]) - 1) // 2, (int(fp_shape[1]) - 1) // 2
    neg = -math.inf
    e = torch.where(valid, lnpi, neg)
    flat = torch.arange(HN, device=dev, dtype=torch.int64).reshape(H, N).expand(S, H, N)

    # --- exact-elevation-tie detector (divergence guard) ---
    # Equality is symmetric, so each unordered pair is checked once via the
    # half footprint {(0, +dj)} U {(+di, any dj)}.  -inf == -inf between
    # cells inside the valid mask is excluded (fin): the flood elevation is
    # undefined there anyway.  Past 441 footprint cells a sorted-adjacent
    # duplicate scan over ALL valid finite cells is a strict superset of
    # the footprint check -- conservative, never silent.
    fin = valid & torch.isfinite(lnpi)
    if (2 * ry + 1) * (2 * rx + 1) <= 441:
        hit = torch.zeros(S, H, N, dtype=torch.bool, device=dev)
        half = [(0, dj) for dj in range(1, rx + 1)] + [(di, dj) for di in range(1, ry + 1) for dj in range(-rx, rx + 1)]
        for di, dj in half:
            hit |= _shifted(fin, di, dj, False) & (e == _shifted(e, di, dj, neg))
        elev_tie = (hit & fin).flatten(1).any(1)
    else:
        v = torch.where(fin, lnpi, math.inf).reshape(S, HN).sort(-1).values
        elev_tie = ((v[:, 1:] == v[:, :-1]) & torch.isfinite(v[:, 1:])).any(1)

    def _fold(best_v, best_i, nv, ni):
        take = (nv > best_v) | ((nv == best_v) & (ni < best_i) & (nv > neg))
        return torch.where(take, nv, best_v), torch.where(take, ni, best_i)

    # the footprint is a full rectangle, so the (value desc, flat asc)
    # window argmax is separable: a column pass (window along axis N,
    # including the center), then a row pass over its winners
    bv, bi = e, flat
    for dj in range(1, rx + 1):
        for sdj in (dj, -dj):
            bv, bi = _fold(bv, bi, _shifted(e, 0, sdj, neg), flat + sdj)
    best_v, best_i = bv, bi
    for di in range(1, ry + 1):
        for sdi in (di, -di):
            best_v, best_i = _fold(best_v, best_i, _shifted(bv, sdi, 0, neg), _shifted(bi, sdi, 0, 0))

    # peak rule == maximum_filter equality test: cell >= all neighbors
    # (invalid cells read -inf like the host's 0 background under the
    # shared shift; see imaging.peak_local_max)
    is_peak = (e == best_v) & valid
    parent = torch.where(is_peak, flat, best_i).reshape(S, HN)

    # rank peaks by (lnPI desc, flat asc): P rounds of max with the first
    # index winning ties reproduce peak_local_max's stable intensity sort +
    # num_peaks slice
    min_valid = torch.where(valid, lnpi, math.inf).amin(_HW)
    score = torch.where(is_peak & (e > min_valid[:, None, None]), e, neg).reshape(S, HN)
    n_found = (score > neg).sum(1, dtype=torch.int32)
    peak_idx, peak_val = [], []
    for _ in range(P):
        v, k = score.max(1)  # the first maximal index, as jnp.argmax
        live = v > neg
        peak_idx.append(torch.where(live, k, HN))
        peak_val.append(torch.where(live, v, 0.0))
        score = score.scatter(1, k[:, None], neg)
    peak_idx = torch.stack(peak_idx, 1)  # [S, P], HN = dead slot
    peak_lnpi = torch.stack(peak_val, 1)

    # marker labels 1..n at the ranked peak cells; dead slots write to the
    # extra column HN, which is dropped
    marker = torch.zeros(S, HN + 1, dtype=torch.int32, device=dev)
    marker.scatter_(1, peak_idx, torch.arange(1, P + 1, dtype=torch.int32, device=dev).expand(S, P).contiguous())
    marker = marker[:, :HN]

    # label propagation: each cell's chain end by pointer jumping
    for _ in range(max(1, math.ceil(math.log2(max(2, HN))))):
        parent = torch.gather(parent, 1, parent)
    labels = torch.where(valid, torch.gather(marker, 1, parent).reshape(S, H, N), 0)

    rc = torch.stack([peak_idx // N, peak_idx % N], -1)
    return {
        "labels": labels,
        "n_labels": torch.clamp(n_found, max=P),
        "peak_lnpi": peak_lnpi,
        "peak_sat": n_found > P,
        "peak_rc": torch.where((peak_idx < HN)[..., None], rc, -1).to(torch.int32),
        "elev_tie": elev_tie,
    }


def hillclimb_segment(lnpi, valid, fp_shape, max_peaks_slots: int):
    """Watershed labels of one surface as a fixed-shape device program.

    Equivalent to the host pipeline's peak_local_max + priority-flood
    pair (imaging.py; pore_hist.pyx:414-423) for surfaces without exact
    elevation ties: peaks are cells >= every in-bounds neighbor (the
    maximum_filter equality test), ranked by decreasing lnPI with
    row-major tie order (peak_local_max's stable sort), and every valid
    cell takes the label of the peak its steepest-ascent chain reaches.

    Parameters
    ----------
    lnpi     : f64[H, N] surface (used directly as the flood elevation --
               the host's ``x = lnpi - min`` offset cancels in every
               comparison)
    valid    : bool[H, N]
    fp_shape : (fy, fx) -- the rectangular footprint's shape, as built by
               pore_pipeline._footprint (both odd)
    max_peaks_slots : P -- label slots (pore max_peaks + 1)

    Returns dict:
      labels    i32[H, N]  0 = background / draining to a trimmed peak
      n_labels  i32[]      live labels, min(found peaks, P)
      peak_lnpi f64[P]     lnPI at each ranked peak (0 pad)
      peak_sat  bool[]     more maxima found than P slots
      peak_rc   i32[P, 2]  ranked peak (row, col); (-1, -1) pad
      elev_tie  bool[]     some valid finite cell has an EXACTLY-equal
                           elevation neighbor inside its footprint window
                           -- the one regime where this engine and the host
                           priority flood legally diverge.  Pipelines
                           surface it as fail_code 4 and can fall back to
                           the host flood (tie_fallback=True).
    """
    lnpi = _t(lnpi, dtype=torch.float64)
    out = hillclimb_segment_batch(lnpi[None], valid, fp_shape, max_peaks_slots)
    return {k: v[0] for k, v in out.items()}


def pore_surface_batch(lnpi_raw, h_vals, fh_vals, p_batch, A, beta_batch, valid):
    """Stage-1 batch: build + normalize S pore surfaces ([S, H, N]) at the
    (p, beta) states.

    Also returns the watershed elevation input x = lnpi - min(lnpi|valid)
    with background exactly 0 (intended form of pore_hist.pyx:412-413).
    """
    lnpi_raw = _t(lnpi_raw, dtype=torch.float64)
    valid = _t(valid, lnpi_raw, torch.bool)
    ln = normalize_2d(build_pore_lnpi(lnpi_raw, h_vals, fh_vals, _t(p_batch, lnpi_raw, torch.float64), A, _t(beta_batch, lnpi_raw, torch.float64)), valid)
    return ln, _elevation(ln, valid)


def _elevation(ln, valid):
    mn = torch.where(valid, ln, math.inf).amin(_HW, keepdim=True)
    return torch.where(valid, ln - mn, 0.0)


def joint_surface_batch(lnpi_raw, op1_vals, op2_vals, beta, dmu1_batch, dmu2_batch, valid):
    """Stage-1 batch for the joint (N_1, N_tot) GC surface: reweight +
    masked-normalize S surfaces.

    A capability beyond the reference (joint_hist.pyx:22-301 is
    assembly+JSON only): the 2-D analog of the 1-D reweight rule
    (gc_hist.pyx:377-406) for a binary system stored as lnPI(N_1, N_tot):

        lnPI'(i, j) = lnPI(i, j) + beta * (dmu1 * N1[i] + dmu2 * N2[i, j])

    with N2 = op2[j] - op1[i] (the species-2 count of the cell).  Invalid
    cells stay -inf.  Returns (lnpi_b [S, H, N], x_b) with x the watershed
    elevation input exactly as pore_surface_batch builds it.
    """
    lnpi_raw = _t(lnpi_raw, dtype=torch.float64)
    valid = _t(valid, lnpi_raw, torch.bool)
    n1 = _t(op1_vals, lnpi_raw, torch.float64)[:, None]  # [H, 1]
    n2 = _t(op2_vals, lnpi_raw, torch.float64)[None, :] - n1  # [H, N]
    dmu1 = _t(dmu1_batch, lnpi_raw, torch.float64)[:, None, None]
    dmu2 = _t(dmu2_batch, lnpi_raw, torch.float64)[:, None, None]
    ln = torch.where(valid, lnpi_raw + beta * (dmu1 * n1 + dmu2 * n2), -math.inf)
    ln = normalize_2d(ln, valid)
    return ln, _elevation(ln, valid)


def pore_sweep_fused(lnpi_raw, h_vals, fh_vals, p_batch, A, beta_batch, valid, edge_idx, props, fp_shape, max_phases: int, boundary_engine: str | None = None):
    """The whole pore state sweep on the device: surface build + normalize,
    device watershed, and per-phase analysis for all S states, with no host
    stage and no label round-trip.

    Returns (lnpi_b, seg, core): the normalized surfaces, the
    hillclimb_segment_batch dict, and the pore_phase_batch dict.
    """
    lnpi_b, _ = pore_surface_batch(lnpi_raw, h_vals, fh_vals, p_batch, A, beta_batch, valid)
    return _fused_tail(lnpi_b, valid, edge_idx, props, fp_shape, max_phases, boundary_engine)


def joint_sweep_fused(lnpi_raw, op1_vals, op2_vals, beta, dmu1_batch, dmu2_batch, valid, edge_idx, props, fp_shape, max_phases: int, boundary_engine: str | None = None):
    """The joint (N_1, N_tot) GC state sweep on the device (the
    joint-surface analog of pore_sweep_fused)."""
    lnpi_b, _ = joint_surface_batch(lnpi_raw, op1_vals, op2_vals, beta, dmu1_batch, dmu2_batch, valid)
    return _fused_tail(lnpi_b, valid, edge_idx, props, fp_shape, max_phases, boundary_engine)


def _fused_tail(lnpi_b, valid, edge_idx, props, fp_shape, max_phases, boundary_engine):
    valid = _t(valid, lnpi_b, torch.bool)
    seg = hillclimb_segment_batch(lnpi_b, valid, fp_shape, max_phases)
    core = pore_phase_batch(lnpi_b, seg["labels"], valid, edge_idx, props, seg["peak_lnpi"], seg["n_labels"], max_phases, boundary_engine=boundary_engine)
    return lnpi_b, seg, core
