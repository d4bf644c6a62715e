"""Phase segmentation and thermodynamic integration, fixed-shape & masked.

The reference finds local extrema with scipy.signal.argrelextrema plus a
4-branch repair scheme (ntot/gc_hist.pyx:317-415), then walks phases with a
running minima counter to set integration bounds (:498-520).  Both involve
data-dependent list lengths; here, as in the JAX package, phase structure is
``max_phases``-padded index arrays + counts + a validity flag.

The core functions take a leading state-point axis: ``x`` is ``[B, N]``
(one reweighted lnPI surface per point) and every result has a leading
``B``.  This module is the plain PyTorch version of the fused sweep kernel
(``csrc/sweep_thermo.cu``); the CPU tests hold it against the JAX package
and ``chip_smoke.py`` holds the kernel against it on the card.
"""

from __future__ import annotations

import dataclasses

import torch

from .moments import unique_row_map
from .numerics import normalize_lnpi
from .state import Hist, HistMeta

BIG = 2**31 - 1  # padding sentinel for index arrays (int32 max)
I32 = torch.int32


@dataclasses.dataclass(frozen=True)
class Extrema:
    """Padded local-extrema structure of B lnPI surfaces."""

    maxima: torch.Tensor  # i32[B, P], padded with BIG
    n_max: torch.Tensor  # i32[B]
    minima: torch.Tensor  # i32[B, P+1], padded with BIG
    n_min: torch.Tensor  # i32[B]
    valid: torch.Tensor  # bool[B] — alternation/order checks passed


@dataclasses.dataclass(frozen=True)
class PhaseThermo:
    """Per-phase thermodynamics, padded to max_phases.

    fe       : f64[B, P]   free energy / kT per phase (default pad value 0)
    left     : i32[B, P]   inclusive left bin of each phase
    right    : i32[B, P]   exclusive right bin
    mask     : bool[B, P]  which slots hold real phases
    mom_avg  : f64[B, P, S, M, S, M, M] probability-averaged moments
    n_phases : i32[B]
    valid    : bool[B]
    """

    fe: torch.Tensor
    left: torch.Tensor
    right: torch.Tensor
    mask: torch.Tensor
    mom_avg: torch.Tensor
    n_phases: torch.Tensor
    valid: torch.Tensor


def _col(c: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A per-point [B] condition shaped to broadcast against ``like``."""
    return c.reshape(c.shape + (1,) * (like.dim() - c.dim()))


def _sel(c, a, b):
    """Per-point select between two tuples of same-shape tensors."""
    return tuple(torch.where(_col(c, x), x, y) for x, y in zip(a, b))


def _compress_indices(flags: torch.Tensor, size: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Indices where flags [B, N] is True, ascending, the first ``size``
    of them padded with BIG, and the full count (which may exceed size)."""
    B, N = flags.shape
    pos = torch.cumsum(flags, dim=-1) - 1  # rank of each flagged bin
    slot = torch.where(flags & (pos < size), pos, size)  # column `size` is a dump
    out = torch.full((B, size + 1), BIG, dtype=I32, device=flags.device)
    idx = torch.arange(N, dtype=I32, device=flags.device).expand(B, N)
    out.scatter_(1, slot, idx)
    return out[:, :size], flags.sum(-1, dtype=I32)


def _prepend(arr, cnt, val):
    head = torch.full_like(arr[:, :1], val)
    return torch.cat([head, arr[:, :-1]], dim=1), cnt + 1


def _append_at(arr, cnt, val):
    slots = torch.arange(arr.shape[1], dtype=I32, device=arr.device)
    v = val[:, None] if torch.is_tensor(val) else val
    return torch.where(slots == cnt[:, None], v, arr), cnt + 1


def _take_small(arr, i):
    """arr[b, i[b]] for a [B, n] array and per-point index, clip mode."""
    return arr.gather(1, i.clamp(0, arr.shape[1] - 1).long()[:, None])[:, 0]


def relextrema(lnpi: torch.Tensor, smooth: int, max_phases: int) -> Extrema:
    """Locate alternating local maxima/minima of each lnPI row [B, N].

    Reproduces argrelextrema(..., order=smooth, mode='clip') semantics plus
    the endpoint-inclusion and over-smoothing repair logic of
    gc_hist.pyx:317-415 (see the JAX package's segment.relextrema for how
    the four reference cases fold into straight-line selects).
    """
    is_max, is_min = stencil_flags(lnpi, smooth)
    return extrema_from_flags(lnpi, is_max, is_min, max_phases)


def stencil_flags(lnpi: torch.Tensor, smooth: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The strict-compare extremum stencil of relextrema (argrelextrema
    clip-mode semantics): bool [B, N] maxima and minima flags."""
    if smooth < 1:
        raise ValueError("smooth must be >= 1 to find relative extrema (scipy argrelextrema rejects order 0 too)")
    N = lnpi.shape[-1]
    idx = torch.arange(N, device=lnpi.device)
    is_max = torch.ones_like(lnpi, dtype=torch.bool)
    is_min = torch.ones_like(lnpi, dtype=torch.bool)
    for k in range(1, smooth + 1):
        up = lnpi[:, (idx + k).clamp(max=N - 1)]
        dn = lnpi[:, (idx - k).clamp(min=0)]
        is_max = is_max & (lnpi > up) & (lnpi > dn)
        is_min = is_min & (lnpi < up) & (lnpi < dn)
    return is_max, is_min


def extrema_from_flags(lnpi: torch.Tensor, is_max: torch.Tensor, is_min: torch.Tensor, max_phases: int) -> Extrema:
    """Endpoint/repair/alternation extraction given the stencil flags."""
    B, N = lnpi.shape
    P = max_phases
    dev = lnpi.device
    last = N - 1

    has_max = is_max.any(-1)
    has_min = is_min.any(-1)
    any_ext = has_max | has_min
    # straight-line fallback folded into the flags (gc_hist.pyx:382-386)
    fmax = torch.where(any_ext[:, None], is_max, lnpi == lnpi.amax(-1, keepdim=True))
    fmin = torch.where(any_ext[:, None], is_min, lnpi == lnpi.amin(-1, keepdim=True))

    maxima0, n_max0 = _compress_indices(fmax, P)
    minima0, n_min0 = _compress_indices(fmin, P + 1)

    max_only = has_max & ~has_min
    min_only = has_min & ~has_max
    none_case = ~any_ext

    # --- both-found endpoint rules (gc_hist.pyx:333-351) ---
    maxima, n_max, minima, n_min = maxima0, n_max0, minima0, n_min0
    zero_in = (maxima[:, 0] == 0) | (minima[:, 0] == 0)
    pre_min = ~zero_in & (maxima[:, 0] < minima[:, 0])
    pre_max = ~zero_in & (maxima[:, 0] > minima[:, 0])
    validB = zero_in | pre_min | pre_max
    minima, n_min = _sel(pre_min, _prepend(minima, n_min, 0), (minima, n_min))
    maxima, n_max = _sel(pre_max, _prepend(maxima, n_max, 0), (maxima, n_max))
    last_mx = _take_small(maxima, n_max - 1)
    last_mn = _take_small(minima, n_min - 1)
    last_in = (last_mx == last) | (last_mn == last)
    app_max = ~last_in & (last_mx < last_mn)
    app_min = ~last_in & (last_mx > last_mn)
    validB = validB & (last_in | app_max | app_min)
    maxima, n_max = _sel(app_max, _append_at(maxima, n_max, last), (maxima, n_max))
    minima, n_min = _sel(app_min, _append_at(minima, n_min, last), (minima, n_min))

    # --- merged over-smoothing repair (gc_hist.pyx:352-381): endpoints +
    # per-gap arg-extremum of the non-found kind between found anchors ---
    big_col = torch.full((B, 1), BIG, dtype=I32, device=dev)
    anchor = torch.where(max_only[:, None], torch.cat([maxima0, big_col], dim=1), minima0)  # [B, P+1]
    n_anchor = torch.where(max_only, n_max0, n_min0)
    slots = torch.arange(P + 1, dtype=I32, device=dev)
    filled = torch.where(slots == 0, 0, BIG).to(I32).expand(B, P + 1)
    if P > 1:
        sx = torch.where(max_only, 1.0, -1.0).to(lnpi.dtype)[:, None] * lnpi
        idx = torch.arange(N, dtype=I32, device=dev)
        gaps = []
        for g in range(P - 1):
            in_gap = (idx >= anchor[:, g : g + 1]) & (idx < anchor[:, g + 1 : g + 2])
            # first occurrence, as np.where(...)[0]; an empty gap reads 0
            gaps.append(torch.argmin(torch.where(in_gap, sx, torch.inf), dim=-1))
        gvals = torch.stack(gaps, dim=1).to(I32)[:, (slots - 1).clamp(0, P - 2).long()]
        filled = torch.where((slots >= 1) & (slots <= n_anchor[:, None] - 1), gvals, filled)
    filled = torch.where(slots == n_anchor[:, None], last, filled)

    # --- select per case (exclusive) ---
    raw_max = max_only | none_case  # cases keeping the compressed maxima as-is
    raw_min = min_only | none_case
    e_max = torch.where(min_only[:, None], filled[:, :P], torch.where(raw_max[:, None], maxima0, maxima))
    e_nmax = torch.where(min_only, n_anchor + 1, torch.where(raw_max, n_max0, n_max))
    e_min = torch.where(max_only[:, None], filled, torch.where(raw_min[:, None], minima0, minima))
    e_nmin = torch.where(max_only, n_anchor + 1, torch.where(raw_min, n_min0, n_min))
    valid = torch.where(max_only | min_only | none_case, True, validB)

    # --- alternation + ordering checks (gc_hist.pyx:402-415) ---
    valid = valid & ((e_nmax - e_nmin).abs() <= 1)
    valid = valid & (e_nmax <= P) & (e_nmin <= P + 1) & (e_nmax >= 1)
    # interleaved order must be non-decreasing
    max_first = (e_max[:, 0] < e_min[:, 0])[:, None]
    total = (e_nmax + e_nmin)[:, None]
    slots2 = torch.arange(2 * (P + 1), device=dev)
    seq_max = e_max[:, (slots2 // 2).clamp(max=P - 1)]
    seq_min = e_min[:, slots2 // 2]
    # even slots from whichever list starts first, odd slots from the other
    even = (slots2 % 2) == 0
    seq = torch.where(even, torch.where(max_first, seq_max, seq_min), torch.where(max_first, seq_min, seq_max))
    in_use = slots2 < total
    ok = torch.where(in_use[:, :-1] & in_use[:, 1:], seq[:, 1:] >= seq[:, :-1], True).all(-1)
    return Extrema(e_max, e_nmax, e_min, e_nmin, valid & ok)


def janus_collect_extrema(ext: Extrema, max_phases: int) -> Extrema:
    """Janus collect: merge all peaks but the last into one micellar-gas
    macrophase (collect.py:32-80) as a masked transform.

    No-op when n_max <= 2; new maxima = [round(mean(maxima[:-1])),
    maxima[-1]] (round half to even, like python's round); new minima =
    optional leading 0, then the boundary minima chosen by the reference's
    last-minimum position cases (collect.py:56-63).  The reference's
    assertion len(minima) > 1 in the trailing-minimum case reads as
    valid=False here.
    """
    P = max_phases
    B = ext.n_max.shape[0]
    slots = torch.arange(P, dtype=I32, device=ext.maxima.device)
    nm1 = ext.n_max - 1
    msum = torch.where(slots < nm1[:, None], ext.maxima, 0).sum(-1)
    mean = torch.round(msum.double() / nm1.clamp(min=1).double()).to(I32)
    mx_last = _take_small(ext.maxima, nm1)
    new_max = torch.where(slots == 0, mean[:, None], torch.where(slots == 1, mx_last[:, None], BIG)).to(I32)

    lead = ext.minima[:, 0] == 0
    last_mn = _take_small(ext.minima, ext.n_min - 1)
    prev_mn = _take_small(ext.minima, ext.n_min - 2)
    mid = (mean < last_mn) & (last_mn < mx_last)
    tail = last_mn > mx_last

    new_min = torch.full_like(ext.minima, BIG)
    cnt = torch.zeros_like(ext.n_min)
    new_min, cnt = _sel(lead, _append_at(new_min, cnt, 0), (new_min, cnt))
    new_min, cnt = _sel(mid, _append_at(new_min, cnt, last_mn), (new_min, cnt))
    new_min, cnt = _sel(tail, _append_at(new_min, cnt, prev_mn), (new_min, cnt))
    new_min, cnt = _sel(tail, _append_at(new_min, cnt, last_mn), (new_min, cnt))

    apply = ext.n_max > 2
    valid = ext.valid & (~apply | ~tail | (ext.n_min > 1))
    two = torch.full((B,), 2, dtype=I32, device=slots.device)
    fields = _sel(apply, (new_max, two, new_min, cnt), (ext.maxima, ext.n_max, ext.minima, ext.n_min))
    return Extrema(*fields, valid)


# registry for the sweep's collect= option: masked Extrema -> Extrema
# transforms keyed by name (the fused kernel implements "janus" only)
COLLECT_TRANSFORMS = {"janus": janus_collect_extrema}


def phase_bounds(ext: Extrema, nbins: int, max_phases: int):
    """Integration bounds per phase via the running minima counter.

    Parity: the min_ctr walk at gc_hist.pyx:498-520, including the
    final-endpoint inclusion rule (right == N-1 -> N).  Maxima are sorted
    and unique, so only phase 0 can have its maximum at bin 0: the counter
    is p, less one when the structure starts with a maximum.
    """
    N = nbins
    P = max_phases
    s = (ext.maxima[:, 0] == 0)[:, None]  # max-first: no leading minimum consumed
    mn = ext.minima
    left_v = torch.where(s, torch.cat([mn[:, :1], mn[:, : P - 1]], dim=1), mn[:, :P])
    right_v = torch.where(s, mn[:, :P], mn[:, 1 : P + 1])
    mx = ext.maxima[:, :P]
    left = torch.where(mx > 0, left_v, 0)
    right = torch.where(mx < N - 1, right_v, N)
    right = torch.where(right == N - 1, N, right)
    mask = torch.arange(P, device=mn.device) < ext.n_max[:, None]
    return left.to(I32), right.to(I32), mask


def _segment_bounds(lnpi, meta: HistMeta, complete: bool, collect=None):
    """Segmentation: padded per-phase bounds + masks for [B, N] surfaces.

    collect: optional COLLECT_TRANSFORMS key (e.g. "janus") applied to the
    extrema between segmentation and the bounds walk (gc_hist.pyx:484-486).
    Ignored for complete=True, as in the reference.
    """
    P = meta.max_phases
    B, N = lnpi.shape
    dev = lnpi.device
    if complete:
        first = torch.arange(P, device=dev) == 0
        lefts = torch.zeros((B, P), dtype=I32, device=dev)
        rights = torch.where(first, N, 0).to(I32).expand(B, P).clone()
        mask = first.expand(B, P).clone()
        n_phases = torch.ones(B, dtype=I32, device=dev)
        valid = torch.ones(B, dtype=torch.bool, device=dev)
    else:
        ext = relextrema(lnpi, meta.smooth, P)
        if collect is not None:
            ext = COLLECT_TRANSFORMS[collect](ext, P)
        lefts, rights, mask = phase_bounds(ext, N, P)
        n_phases = ext.n_max
        valid = ext.valid
    return lefts, rights, mask, n_phases, valid


def _in_range(lefts, rights, mask, N):
    idx = torch.arange(N, device=lefts.device)
    return (idx >= lefts[..., None]) & (idx < rights[..., None]) & mask[..., None]  # [B, P, N]


def _phase_weights(lnpi, lefts, rights, mask):
    """Per-phase-shifted probability weight pieces for [B, N] surfaces.

    Returns (sel [B,P,N], e [B,N], e_last [B,P], m_pf [B,P], wsum [B,P]):
    each bin's weight is exp(lnpi - m_p) under its covering phase's own
    maximum (segment.py of the JAX package explains why a global shift
    underflows subdominant phases).  The shared bin N-1 (the right==N-1 ->
    N endpoint rule is the only way adjacent phases overlap) is left out of
    ``sel`` and added per phase as e_last = exp(lnpi[N-1] - m_p).
    """
    N = lnpi.shape[-1]
    last = N - 1
    in_range = _in_range(lefts, rights, mask, N)
    m_p = torch.where(in_range, lnpi[:, None, :], -torch.inf).amax(-1)  # [B, P]
    m_pf = torch.where(torch.isfinite(m_p), m_p, 0.0)
    # per-bin shift: the covering phase's max; uncovered bins fall back to
    # the global max (exp <= 1 always, they contribute to no sum)
    covered = in_range.any(1)
    sh = torch.where(covered, torch.where(in_range, m_pf[:, :, None], -torch.inf).amax(1), lnpi.amax(-1, keepdim=True))
    e = torch.exp(lnpi - sh)  # [B, N]

    in_last = (lefts <= last) & (last < rights) & mask  # [B, P]
    e_last = torch.where(in_last, torch.exp(lnpi[:, last : last + 1] - m_pf), 0.0)
    sel = in_range.clone()
    sel[..., last] = False
    wsum = torch.where(sel, e[:, None, :], 0.0).sum(-1) + e_last
    return sel, e, e_last, m_pf, wsum


def _fe(lnpi, m_pf, wsum, mask):
    """fe_p = lnpi[0] - m_p - log(sum_p) == -logsumexp(lnpi[seg] - lnpi[0])
    (gc_hist.pyx:523-526); +inf on a masked phase with no mass, 0 off mask."""
    pos = wsum > 0
    fe = lnpi[:, :1] - m_pf - torch.log(torch.where(pos, wsum, 1.0))
    return torch.where(mask & pos, fe, torch.where(mask, torch.inf, 0.0))


def _zeros_mom_avg(lnpi, meta: HistMeta):
    # a zero-stride view: the JAX package's dead mom_avg costs no memory
    # there (XLA drops it), so it must not cost [B, P, A] f64 here
    shape = (lnpi.shape[0], meta.max_phases) + meta.mom_shape(1)[:-1]
    return lnpi.new_zeros(()).expand(shape)


def thermo(h: Hist, meta: HistMeta, props: bool = True, complete: bool = False, dedupe_mom: bool = True, collect=None):
    """Normalize, segment, and integrate per-phase thermodynamics of one
    Hist.  Parity: histogram.thermo (gc_hist.pyx:451-554).  Returns the
    normalized state and a PhaseThermo.

    A Hist with a leading state axis [T] (lnpi [T, N], mom [T, ...] or
    shared) is the batch JAX's thermo takes under vmap: each state is
    segmented and integrated with its own moments, and the PhaseThermo
    has the leading [T].  On the card as on the CPU the batch runs this
    module's plain body as tensor operations: no kernel takes a batch of
    arbitrary states with their own moments (K1 and K2 sweep one
    histogram over mu and targets)."""
    lnpi = normalize_lnpi(h.lnpi)
    if lnpi.dim() == 2:
        return h.replace(lnpi=lnpi), thermo_core(lnpi, h.mom, meta, props=props, complete=complete, dedupe_mom=dedupe_mom, collect=collect)
    pt = thermo_core(lnpi[None], h.mom, meta, props=props, complete=complete, dedupe_mom=dedupe_mom, collect=collect)
    return h.replace(lnpi=lnpi), _unbatch(pt)


def _unbatch(pt: PhaseThermo) -> PhaseThermo:
    return PhaseThermo(**{f.name: getattr(pt, f.name)[0] for f in dataclasses.fields(pt)})


def thermo_core(
    lnpi: torch.Tensor,
    mom: torch.Tensor,
    meta: HistMeta,
    props: bool = True,
    complete: bool = False,
    dedupe_mom: bool = True,
    collect=None,
) -> PhaseThermo:
    """Segmentation + integration on [B, N] (possibly unnormalized) lnPI
    surfaces sharing one moments tensor, or each with its own ([B, ...]).

    dedupe_mom exploits the storage symmetry mom[i,j,k,m,p] ==
    mom[k,m,i,j,p] (always true for simulator-written composites) to
    contract only the physically unique rows.  Set False for hand-built
    asymmetric tensors.
    """
    N = lnpi.shape[-1]
    lefts, rights, mask, n_phases, valid = _segment_bounds(lnpi, meta, complete, collect)
    sel, e, e_last, m_pf, wsum = _phase_weights(lnpi, lefts, rights, mask)
    fe = _fe(lnpi, m_pf, wsum, mask)

    if props:
        mom2d = mom.reshape(mom.shape[:-6] + (meta.n_addr, N))  # [(B,) A, N]
        if dedupe_mom:
            uniq, inverse = unique_row_map(meta.nspec, meta.max_order)
            mom_rows = mom2d[..., uniq, :]  # [(B,) U, N]
        else:
            mom_rows = mom2d
        # masked sums as a [P, N] x [N, U] product per point: the 0/1 mask
        # makes every product exact, only the summation order differs
        pm = torch.einsum("bpn,bun->bpu", sel.to(lnpi.dtype), e[:, None, :] * mom_rows)
        pm = pm + e_last[:, :, None] * mom_rows[..., N - 1].unsqueeze(-2)
        if dedupe_mom:
            pm = pm[:, :, inverse]
        pm = pm / torch.where(wsum > 0, wsum, 1.0)[:, :, None]
        mom_avg = pm.reshape((lnpi.shape[0], meta.max_phases) + meta.mom_shape(1)[:-1])
    else:
        mom_avg = _zeros_mom_avg(lnpi, meta)
    return PhaseThermo(fe=fe, left=lefts, right=rights, mask=mask, mom_avg=mom_avg, n_phases=n_phases, valid=valid)


def key_row_addresses(meta: HistMeta) -> list:
    """Flat mom-row addresses of <N_i> (i,1,0,0,0) per species then <U>
    (0,0,0,0,1) — the rows phase_props reads (gc_hist.pyx:543-552)."""
    S, M1 = meta.nspec, meta.max_order + 1
    return [(i * M1 + 1) * S * M1 * M1 for i in range(S)] + [1]


def key_rows(mom: torch.Tensor, meta: HistMeta) -> torch.Tensor:
    """The [(B,) S+1, N] key moment rows (see key_row_addresses) of one
    moments tensor or of one per state.  Stacked from views: indexing with
    a list would copy the index from pageable host memory, which waits for
    the device and stalls the sweep's launch."""
    mom2d = mom.reshape(mom.shape[:-6] + (meta.n_addr, mom.shape[-1]))
    return torch.stack([mom2d[..., a, :] for a in key_row_addresses(meta)], dim=-2)


def thermo_core_props(lnpi, mom, meta: HistMeta, volume, complete: bool = False, collect=None):
    """Segmentation + phase properties WITHOUT the full mom_avg tensor:
    phase_props reads only the <N_i> and <U> rows (gc_hist.pyx:543-552)."""
    return thermo_key_core(lnpi, key_rows(mom, meta), meta, volume, complete=complete, collect=collect)


def thermo_key_core(lnpi, key, meta: HistMeta, volume, complete: bool = False, collect=None, bounds=None):
    """thermo_core_props given pre-sliced key rows ([S+1, N], shared by all
    points, or [B, S+1, N]).

    bounds: optional precomputed (lefts, rights, mask, n_phases, valid)
    from _segment_bounds, for callers that segment once and share."""
    N = lnpi.shape[-1]
    S = meta.nspec
    if bounds is None:
        bounds = _segment_bounds(lnpi, meta, complete, collect)
    lefts, rights, mask, n_phases, valid = bounds
    sel, e, e_last, m_pf, _ = _phase_weights(lnpi, lefts, rights, mask)

    # a leading ones row folds the wsum reduction into the same product;
    # bin N-1 enters per phase with that phase's own shift
    key1 = torch.cat([torch.ones_like(key[..., :1, :]), key], dim=-2)  # [(B,) S+2, N]
    pk = e[:, None, :] * key1  # [B, S+2, N]
    pm0 = torch.einsum("bpn,bkn->bpk", sel.to(lnpi.dtype), pk)  # [B, P, S+2]
    pm0 = pm0 + e_last[:, :, None] * key1[..., N - 1].unsqueeze(-2)
    wsum = pm0[..., 0]
    fe = _fe(lnpi, m_pf, wsum, mask)

    pm = pm0[..., 1:] / torch.where(wsum > 0, wsum, 1.0)[..., None]
    n_i = pm[..., :S]  # [B, P, S]
    u = pm[..., S]  # [B, P]
    ntot = n_i.sum(-1)
    x_i = n_i / torch.where(ntot != 0, ntot, 1.0)[..., None]
    props = {"n_i": n_i, "ntot": ntot, "density": ntot / volume, "u": u, "x_i": x_i}
    pt = PhaseThermo(fe=fe, left=lefts, right=rights, mask=mask, mom_avg=_zeros_mom_avg(lnpi, meta), n_phases=n_phases, valid=valid)
    return pt, props


def thermo_props(h: Hist, meta: HistMeta, complete: bool = False, collect=None):
    """normalize + thermo_core_props for one Hist, or for a batch of
    states as ``thermo`` takes it (same route)."""
    lnpi = normalize_lnpi(h.lnpi)
    if lnpi.dim() == 2:
        pt, props = thermo_core_props(lnpi, h.mom, meta, _per_state_col(h.volume), complete=complete, collect=collect)
        return h.replace(lnpi=lnpi), pt, props
    pt, props = thermo_core_props(lnpi[None], h.mom, meta, h.volume, complete=complete, collect=collect)
    return h.replace(lnpi=lnpi), _unbatch(pt), {k: v[0] for k, v in props.items()}


def _per_state_col(volume):
    """A volume per state [B] as a column [B, 1] over the phases; a
    shared (scalar) volume unchanged."""
    return volume[..., None] if torch.is_tensor(volume) and volume.dim() else volume


def phase_props(pt: PhaseThermo, volume) -> dict:
    """Extensive per-phase properties from averaged moments.

    Parity: gc_hist.pyx:543-552 (n_i, ntot, density, u, x_i).  Works on
    batched and unbatched PhaseThermo alike; with a batch the volume is
    shared or one per state ([B]).
    """
    n_i = pt.mom_avg[..., :, 1, 0, 0, 0]  # [(B,) P, S]
    ntot = n_i.sum(-1)
    u = pt.mom_avg[..., 0, 0, 0, 0, 1]
    x_i = n_i / torch.where(ntot != 0, ntot, 1.0)[..., None]
    return {"n_i": n_i, "ntot": ntot, "density": ntot / _per_state_col(volume), "u": u, "x_i": x_i}


def is_safe(h: Hist, meta: HistMeta, cutoff: float = 10.0, complete: bool = False):
    """Edge-effect guard (gc_hist.pyx:556-596) for one (unbatched) Hist."""
    lnpi = h.lnpi
    if complete:
        return (lnpi.amax(-1) - lnpi[-1]) >= cutoff
    ext = relextrema(normalize_lnpi(lnpi)[None], meta.smooth, meta.max_phases)
    last_max = _take_small(ext.maxima, ext.n_max - 1)
    return (_take_small(lnpi[None], last_max)[0] - lnpi[-1]) >= cutoff
