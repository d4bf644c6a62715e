"""Phase segmentation and per-phase integration of [B, N] lnPI surfaces,
fixed-shape and masked: the reference's argrelextrema with its four
repair branches and the min_ctr bounds walk (FHMCAnalysis
ntot/gc_hist.pyx:317-415, 451-554), a frozen plain-PyTorch copy.  Any
float dtype: the control runs it in float32.
"""

from __future__ import annotations

import dataclasses

import torch

from .state import HistMeta

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


def key_addresses(nspec: int) -> list:
    """The moment addresses of the key rows: <N_i> per species, then <U>
    (gc_hist.pyx:543-552)."""
    return [(i, 1, 0, 0, 0) for i in range(nspec)] + [(0, 0, 0, 0, 1)]


def key_rows(mom: torch.Tensor, meta: HistMeta) -> torch.Tensor:
    """The [S+1, N] key rows of one moments tensor."""
    return torch.stack([mom[a] for a in key_addresses(meta.nspec)])


def segment(lnpi, meta: HistMeta):
    """(left, right, mask, n_phases, valid) of [B, N] surfaces."""
    ext = relextrema(lnpi, meta.smooth, meta.max_phases)
    left, right, mask = phase_bounds(ext, lnpi.shape[-1], meta.max_phases)
    return left, right, mask, ext.n_max, ext.valid


def thermo_key(lnpi, key, meta: HistMeta, volume) -> dict:
    """Segmentation, free energies and the phase properties from the key
    rows <N_i>, <U> (key [S+1, N] shared, or [B, S+1, N])."""
    N, S = lnpi.shape[-1], meta.nspec
    left, right, mask, n_phases, valid = segment(lnpi, meta)
    sel, e, e_last, m_pf, _ = _phase_weights(lnpi, left, right, mask)
    key1 = torch.cat([torch.ones_like(key[..., :1, :]), key], dim=-2)  # [(B,) S+2, N]
    pk = e[:, None, :] * key1
    pm0 = torch.einsum("bpn,bkn->bpk", sel.to(lnpi.dtype), pk)
    pm0 = pm0 + e_last[:, :, None] * key1[..., N - 1].unsqueeze(-2)
    wsum = pm0[..., 0]
    fe = _fe(lnpi, m_pf, wsum, mask)
    pm = pm0[..., 1:] / torch.where(wsum > 0, wsum, 1.0)[..., None]
    n_i = pm[..., :S]
    ntot = n_i.sum(-1)
    x_i = n_i / torch.where(ntot != 0, ntot, 1.0)[..., None]
    return {"fe": fe, "mask": mask, "left": left, "right": right, "n_phases": n_phases, "valid": valid,
            "n_i": n_i, "x_i": x_i, "ntot": ntot, "u": pm[..., S], "density": ntot / volume}
