"""The plain reference of the slit-pore state sweep, and the numbers that
decide ``correct`` for it.

One state at a time, as pore_hist.pyx analyses one pore_hist instance:
the surface build (:131-135) and the masked normalisation over the
ragged edge (:57-80, :146-152); ``_segment`` (:377-477): the scaled
footprint (:396-409), peak_local_max (:414), markers in descending peak
order and a priority-flood watershed on -lnPI (:416-423), and the
transition states on the boundaries between phases (:425-447);
``phase_average`` (:186-252): each phase's probability averages
(``thermo``, :154-184), its F.E./kT, the ridgeline guard and the
activation matrices.  The flood is a heapq flood of its own, not the
program's steepest-ascent watershed.  Dense steps in plain PyTorch on the
CPU, the flood and the boundary loop in Python; every value in the dtype
given (the control runs float32).  Imports nothing of the program.

Where the sweep reports what pore_hist raises (pore_hist.py "Cannot
segment", "ridgeline effects"), this reference reports the sweep's fail
codes: 3 more maxima than the slots, 2 no maximum, 1 ridgeline effects,
0 ok.
"""

from __future__ import annotations

import heapq
import math

import numpy as np
import torch

PORE_CUTOFF = 10.0  # pore_hist.pyx:196
SEG = ("n_phases", "phase_ok", "ridge_ok", "fail_code", "local_maxima", "labels")
# neighbours of the boundary loop, in its order (pore_hist.pyx:425-447)
NEBR = ((1, 1), (1, 0), (1, -1), (0, -1), (-1, -1), (-1, 0), (-1, 1), (0, 1))


def footprint(H: int, N: int, nnebr: int) -> tuple[int, int]:
    """(rows, columns) of the watershed footprint scaled to the surface
    (pore_hist.pyx:396-409); every cell of it is set."""
    n_incrs, h_incrs = float(N - 1), float(H - 1)
    scale_h, scale_n = (1.0, h_incrs / n_incrs) if h_incrs >= n_incrs else (n_incrs / h_incrs, 1.0)
    return int(np.round(scale_n * nnebr)) * 2 + 1, int(np.round(scale_h * nnebr)) * 2 + 1


def _lse(x: torch.Tensor) -> torch.Tensor:
    m = x.max()
    return m + torch.log(torch.exp(x - m).sum())


def surface(s: dict, fh: list, p: float, A: float, beta: float, dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """(lnPI, valid) of one state: each row shifted by -beta (F(h) + p A h)
    - lnPI[h, 0] (pore_hist.pyx:131-135), then normalised over the cells
    up to each row's edge (:57-80)."""
    raw = torch.as_tensor(s["lnpi"], dtype=dtype)
    h = torch.as_tensor(s["h"], dtype=dtype)
    f = torch.zeros_like(h)
    for c in fh:  # F(h), coefficients from the leading order (free_energy_profile.pyx:71-107)
        f = f * h + c
    ln = raw + (-beta * (f + p * A * h) - raw[:, 0])[:, None]
    valid = torch.arange(raw.shape[1])[None, :] <= torch.as_tensor(s["edge"])[:, None]
    return ln - _lse(ln[valid]), valid


def peaks(x: np.ndarray, fp: tuple[int, int], num: int) -> np.ndarray:
    """peak_local_max(x, min_distance=nnebr, exclude_border=0, num_peaks=num,
    footprint) (pore_hist.pyx:414): cells equal to the maximum over their
    footprint window and above the image's minimum, by decreasing value,
    the first num.  The window reads -inf past the image (skimage reads 0
    there; x >= 0, so the two agree); equal values keep row-major order
    (skimage's sort leaves that order open)."""
    ry, rx = (fp[0] - 1) // 2, (fp[1] - 1) // 2
    H, N = x.shape
    pad = np.full((H + 2 * ry, N + 2 * rx), -np.inf, dtype=x.dtype)
    pad[ry : ry + H, rx : rx + N] = x
    mx = np.full_like(x, -np.inf)
    for di in range(2 * ry + 1):
        for dj in range(2 * rx + 1):
            mx = np.maximum(mx, pad[di : di + H, dj : dj + N])
    rc = np.argwhere((x == mx) & (x > x.min()))
    return rc[np.argsort(-x[rc[:, 0], rc[:, 1]], kind="stable")][:num]


def flood(elev: np.ndarray, lm: np.ndarray, valid: np.ndarray, fp: tuple[int, int]) -> np.ndarray:
    """Priority-flood watershed (skimage.morphology.watershed, pore_hist.pyx:423):
    marker i + 1 at lm[i]; the lowest elevation pops first, the earlier
    push among equals; a popped cell gives its label to every unlabelled
    valid cell of its footprint window, which is pushed."""
    ry, rx = (fp[0] - 1) // 2, (fp[1] - 1) // 2
    H, N = elev.shape
    W = N + 2 * rx  # a margin of invalid cells: no bounds test in the loop
    free = np.zeros((H + 2 * ry, W), dtype=bool)
    free[ry : ry + H, rx : rx + N] = valid
    val = np.zeros((H + 2 * ry, W))
    val[ry : ry + H, rx : rx + N] = elev
    free, val = free.ravel().tolist(), val.ravel().tolist()
    lab = [0] * len(free)
    offs = [di * W + dj for di in range(-ry, ry + 1) for dj in range(-rx, rx + 1) if di or dj]
    heap, count = [], 0
    for (r, c), a in sorted((tuple(rc), i + 1) for i, rc in enumerate(lm.tolist())):  # pushed in row-major order
        k = (r + ry) * W + c + rx
        lab[k], free[k] = a, False
        heap.append((val[k], count, k))
        count += 1
    heapq.heapify(heap)
    while heap:
        _, _, k = heapq.heappop(heap)
        a = lab[k]
        for d in offs:
            q = k + d
            if free[q]:
                free[q] = False
                lab[q] = a
                heapq.heappush(heap, (val[q], count, q))
                count += 1
    return np.asarray(lab, dtype=np.int64).reshape(H + 2 * ry, W)[ry : ry + H, rx : rx + N]


def boundaries(lab: np.ndarray) -> np.ndarray:
    """find_boundaries(labels, connectivity=1, mode='inner', background=0)
    (pore_hist.pyx:430): a labelled cell with a 4-neighbour of another
    label, the image's edge padded by itself."""
    pad = np.pad(lab, 1, mode="edge")
    H, N = lab.shape
    out = np.zeros(lab.shape, dtype=bool)
    for di, dj in ((-1, 0), (1, 0), (0, -1), (0, 1)):
        out |= lab != pad[1 + di : 1 + di + H, 1 + dj : 1 + dj + N]
    return out & (lab != 0)


def transition(sd: np.ndarray, lab: np.ndarray, n: int) -> tuple[np.ndarray, np.ndarray]:
    """(min_df, max_val) of pore_hist.pyx:425-447: over every boundary cell
    and each of its 8 neighbours in another live phase, a running
    logaddexp and max of logaddexp(lnPI_p - ln 2, lnPI_q - ln 2), kept
    symmetric, from -max float (:40; the dtype's own largest)."""
    big = -np.finfo(sd.dtype).max
    min_df = np.full((n + 1, n + 1), big, dtype=sd.dtype)
    max_val = np.full((n + 1, n + 1), big, dtype=sd.dtype)
    ln2 = sd.dtype.type(math.log(2.0))
    H, N = lab.shape
    for i, j in zip(*np.nonzero(boundaries(lab))):
        a = lab[i, j]
        for k, m in NEBR:
            if 0 <= i + k < H and 0 <= j + m < N:
                b = lab[i + k, j + m]
                if b != a and b > 0 and a > 0:
                    v = np.logaddexp(sd[i, j] - ln2, sd[i + k, j + m] - ln2)
                    min_df[a, b] = min_df[b, a] = np.logaddexp(min_df[a, b], v)
                    max_val[a, b] = max_val[b, a] = max(max_val[a, b], v)
    return min_df, max_val


def state(s: dict, cfg: dict, p: float, beta: float, dtype) -> dict:
    """The sweep's outputs for one (p, beta) state, slot-padded to
    P = max_peaks + 1 (pore_hist.phase_average's slot for the background)."""
    P = cfg["max_peaks"] + 1
    ln, valid = surface(s, cfg["fh"], p, cfg["A"], beta, dtype)
    H, N = ln.shape
    fp = footprint(H, N, cfg["nnebr"])
    # the valid cells shifted to >= 0, the rest exactly 0 (intended form of
    # :412-413, which zeroes the valid cells instead)
    x = torch.where(valid, ln - ln[valid].min(), 0.0).numpy()
    lm = peaks(x, fp, P + 1)  # one more than the slots: saturation shows
    sat, lm = len(lm) > P, lm[:P]
    n = len(lm)
    lab = flood(-x, lm, valid.numpy(), fp)
    sd = ln.numpy()
    min_df, max_val = transition(sd, lab, n)

    ln_f = _lse(ln[:, 0])  # :205
    props = sorted(s["props"])
    prop = torch.stack([torch.as_tensor(s["props"][k], dtype=dtype) for k in props])
    labt = torch.as_tensor(lab)
    ave = torch.zeros(P, len(props), dtype=dtype)
    fe = torch.zeros(P, dtype=dtype)
    ridge_ok = True
    rows = torch.arange(H)
    edge = torch.as_tensor(s["edge"])
    for hill in range(1, n + 1):
        mask = labt == hill
        # thermo (:154-184): lnPI over the phase, renormalised there
        lp = ln - ln[mask].max()
        lp = torch.where(mask, lp, -math.inf)
        lp = lp - _lse(lp[mask])
        prob = torch.exp(lp)
        ave[hill - 1] = (prob * prop).sum((1, 2)) / prob.sum()
        fe[hill - 1] = ln_f - _lse(ln[mask])
        # ridgeline guard (intended form of :230-234: each row's own edge cell)
        ridge = torch.where(mask[rows, edge], ln[rows, edge], -math.inf)
        ridge_ok &= bool(ln[mask].max() - ridge.max() >= PORE_CUTOFF)

    # transition states in -kT units (:205-210), activation matrices (:213-227)
    live = min_df > -np.finfo(sd.dtype).max
    ts = np.where(live, -(min_df - ln_f.numpy()), min_df)
    fe_n = fe.numpy()
    act = np.zeros((P, P), dtype=sd.dtype)
    act_diff = np.zeros((P, P), dtype=sd.dtype)
    for i in range(1, n + 1):
        for j in range(i + 1, n + 1):
            if live[i, j]:
                act[i - 1, j - 1] = act[j - 1, i - 1] = ts[i, j] - max(fe_n[i - 1], fe_n[j - 1])
                act_diff[i - 1, j - 1] = act_diff[j - 1, i - 1] = min(sd[tuple(lm[i - 1])], sd[tuple(lm[j - 1])]) - max_val[i, j]
    fail = 3 if sat else 2 if n == 0 else 1 if not ridge_ok else 0
    return {"ave": ave.numpy(), "fe": fe_n, "act_kT": act, "act_kT_diff": act_diff, "n_phases": n, "phase_ok": np.arange(P) < n,
            "ridge_ok": ridge_ok, "fail_code": fail, "local_maxima": lm.astype(np.int64), "labels": lab, "prop_names": props}


def states(s: dict, cfg: dict, p_vals, beta_vals, dtype) -> dict:
    """state() over paired (p, beta) lists, stacked along a leading axis
    (local_maxima a list)."""
    one = [state(s, cfg, float(p), float(b), dtype) for p, b in zip(p_vals, beta_vals)]
    out = {k: [o[k] for o in one] for k in one[0] if k != "prop_names"}
    out = {k: (v if k == "local_maxima" else np.stack([np.asarray(x) for x in v])) for k, v in out.items()}
    out["prop_names"] = one[0]["prop_names"]
    return out


def rows(out: dict, idx) -> dict:
    """The rows idx of a sweep's output dict, on the host."""
    got = {}
    for k in SEG + ("ave", "fe", "act_kT", "act_kT_diff"):
        v = out[k]
        got[k] = [v[i] for i in idx] if k == "local_maxima" else (v[list(idx)].cpu().numpy() if torch.is_tensor(v) else np.asarray(v)[list(idx)])
    got["prop_names"] = list(out["prop_names"])
    return got


def _gap(got, want, where) -> float:
    """The widest |got - want| / max(|want|, 1) over where; equal values,
    infinities included, read 0, and NaN reads inf."""
    g, w = np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64)
    with np.errstate(invalid="ignore"):
        d = np.where(g == w, 0.0, np.abs(g - w) / np.maximum(np.abs(w), 1.0))
    d = np.where(where, np.nan_to_num(d, nan=np.inf), 0.0)
    return float(d.max()) if d.size else 0.0


def numbers(got: dict, want: dict) -> dict:
    """The numbers of rows got against the reference's rows want for the
    same states: seg_mismatch, the states whose n_phases, phase_ok,
    ridge_ok, fail_code, local_maxima or labels differ; fe_gap, the widest
    relative gap of fe, act_kT and act_kT_diff over the slots both hold
    alike (the live slots of states that agree); prop_gap, the same over
    the probability averages, matched by property name."""
    S = len(want["n_phases"])
    agree = np.array([all(np.array_equal(np.asarray(got[k][s]), np.asarray(want[k][s])) for k in SEG) for s in range(S)])
    live = np.asarray(want["phase_ok"]) & agree[:, None]
    pair = live[:, :, None] & live[:, None, :]
    cols = [list(got["prop_names"]).index(k) for k in want["prop_names"]]
    fe = max(_gap(got["fe"], want["fe"], live), _gap(got["act_kT"], want["act_kT"], pair), _gap(got["act_kT_diff"], want["act_kT_diff"], pair))
    return {"seg_mismatch": int((~agree).sum()), "fe_gap": fe, "prop_gap": _gap(np.asarray(got["ave"])[..., cols], want["ave"], live[..., None])}
