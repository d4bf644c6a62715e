"""Batched pipeline over slit-pore state points (p, beta).

The PyTorch port of the JAX package's ``two_dim/pore_pipeline.py``, the 2-D
analog of core/pipeline.mu_sweep_thermo: the reference analyzes one pore
state per pore_hist instance (pore_hist.pyx:82-252, serial host loops);
here a whole grid of (p, beta) targets runs through the card with the
state axis S leading every tensor.  Two watershed engines:

  device  surfaces, the fixed-shape steepest-ascent watershed
          (segment2d.hillclimb_segment_batch) and the per-phase analysis
          all on the card (segment2d.pore_sweep_fused); the small per-phase
          outputs come back in one synchronisation
  host    stage 1 (surface build + normalize) on the card, the
          reference-exact priority flood per state on the host
          (imaging.py, native C++ flood), then stage 2 (per-phase
          averages, free energies, ridge diagnostics, transition states,
          activation matrices) on the card for every state at once

Failure handling follows the framework invariant: ridgeline effects and
empty states become per-state mask/validity flags, not exceptions (the
class path pore_hist.phase_average keeps the reference's raise semantics).
"""

from __future__ import annotations

import copy
import os

import numpy as np
import torch

from ..core import segment2d as _s2d
from ..core.state import _device
from ..parallel.mesh import _blocks, _on
from .imaging import peak_local_max, watershed

__all__ = ["pore_state_sweep"]

_PORE_CUTOFF = 10.0  # ridgeline bar (pore_hist.pyx:196)


def _resolve_segment_engine(segment_engine: str, device: torch.device) -> str:
    """'auto' picks the device watershed when the sweep runs on the card and
    the reference-exact host priority flood on the CPU.  The two agree
    exactly on surfaces without exact elevation ties whenever the peak
    slots do not saturate (fail_code 3); the host arm stays selectable as
    the cross-check, the same dual-arm discipline as
    segment2d.BOUNDARY_SEGMENT_ENGINE."""
    if segment_engine == "auto":
        return "device" if device.type == "cuda" else "host"
    assert segment_engine in ("host", "device"), segment_engine
    return segment_engine


def _devices(mesh, device) -> list:
    """The devices a sweep runs on: the mesh's in mesh order, or the one
    ``device`` names (None: the card)."""
    if mesh is None:
        return [_device(device)]
    if device is not None:
        raise ValueError("pass device= or mesh=, not both: a mesh names the devices the sweep runs on")
    return mesh.device_list()


def _footprint(len_H: int, len_N: int, nnebr: int):
    """Scaled watershed footprint (pore_hist.pyx:396-409) — depends on
    the surface shape only, shared by every state in the batch."""
    assert len_H > 1 and len_N > 1, (
        "pore surface must span at least 2 h values and 2 N_tot bins "
        "(got %d x %d); a 1-row/1-column joint histogram cannot be "
        "segmented" % (len_H, len_N)
    )
    n_incrs = float(len_N - 1)
    h_incrs = float(len_H - 1)
    if h_incrs >= n_incrs:
        scale_h, scale_n = 1.0, h_incrs / n_incrs
    else:
        scale_h, scale_n = n_incrs / h_incrs, 1.0
    fp_x = int(np.round(scale_n * nnebr)) * 2 + 1
    fp_y = int(np.round(scale_h * nnebr)) * 2 + 1
    return np.ones((fp_x, fp_y))


def _fetch(tensors: dict) -> dict:
    """Host numpy copies of a dict of tensors with one wait: every copy off
    the card is queued first, then the host synchronises once."""
    host = {k: v.to("cpu", non_blocking=True) for k, v in tensors.items()}
    for dev in {v.device for v in tensors.values() if v.is_cuda}:
        torch.cuda.synchronize(dev)
    return {k: v.numpy() for k, v in host.items()}


def _elevation_host(lnpi_b, valid):
    """The watershed elevation input x = lnpi - min(lnpi|valid), background
    exactly 0, of host surfaces [S, H, N] (segment2d.pore_surface_batch's x)."""
    mn = np.min(np.where(valid, lnpi_b, np.inf), axis=(1, 2))
    return np.where(valid, lnpi_b - mn[:, None, None], 0.0)


def _segment_batch_host(x_b, lnpi_b, valid, fp, nnebr, P):
    """Peak finding + watershed flood for a batch of independent states.

    Each state probes one extra peak: truncation is a stable sorted
    slice, so lm[:P] is exactly the num_peaks=P answer while len==P+1
    proves the padding saturated (fail_code 3).

    States are independent, so above a handful the loop runs on a small
    thread pool: scipy's maximum_filter and the native C++ flood
    (imaging.cpp) both release the GIL, so the floods genuinely overlap.
    Results are bit-identical to the serial loop — every write lands in
    a distinct [s] slot.
    """
    SP, H, N = x_b.shape
    labels_b = np.zeros((SP, H, N), dtype=np.int32)
    n_labels = np.zeros(SP, dtype=np.int64)
    peak_lnpi = np.zeros((SP, P), dtype=np.float64)
    peak_sat = np.zeros(SP, dtype=bool)
    local_maxima = [None] * SP

    def _one(s):
        lm = peak_local_max(x_b[s], min_distance=nnebr, exclude_border=0, num_peaks=P + 1, footprint=fp)
        peak_sat[s] = len(lm) > P
        lm = lm[:P]
        local_maxima[s] = lm
        n_max = len(lm)
        n_labels[s] = n_max
        markers = np.zeros((H, N), dtype=int)
        for i in range(n_max):
            markers[lm[i][0], lm[i][1]] = i + 1
        labels_b[s] = watershed(-x_b[s], markers=markers, mask=valid, connectivity=fp)
        if n_max:
            peak_lnpi[s, :n_max] = lnpi_b[s, lm[:, 0], lm[:, 1]]

    try:
        workers = len(os.sched_getaffinity(0))  # honours CPU pinning
    except AttributeError:  # non-Linux
        workers = os.cpu_count() or 1
    if SP >= 8 and workers > 1:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(min(8, workers)) as ex:
            list(ex.map(_one, range(SP)))
    else:
        for s in range(SP):
            _one(s)
    return labels_b, n_labels, peak_lnpi, peak_sat, local_maxima


def _tie_fallback(flagged, lnpi_dev, inputs, fp, nnebr, P, core, n_labels, peak_sat, local_maxima, labels_b):
    """Re-run tie-flagged states through the reference-exact host flood
    (imaging.py priority flood, pore_hist.pyx:414-423 semantics): their
    rows of the device surfaces come to the host once, are flooded there,
    and go through stage 2 again on the card; the results are spliced over
    the device-engine outputs in place (numpy arrays), or into a copy of
    the label tensor where the labels stay on the card.

    Returns (n_labels, peak_sat, labels_b) updated."""
    valid, valid_t, edge_t, props_t = inputs
    idx = torch.as_tensor(flagged, device=lnpi_dev.device)
    lnpi_flag_dev = lnpi_dev[idx]
    lnpi_flag = _fetch({"lnpi": lnpi_flag_dev})["lnpi"]
    lab_f, nl_f, pk_f, sat_f, lm_f = _segment_batch_host(_elevation_host(lnpi_flag, valid), lnpi_flag, valid, fp, nnebr, P)
    lab_f_dev = torch.as_tensor(lab_f, device=lnpi_dev.device)
    core_f = _fetch(_s2d.pore_phase_batch(lnpi_flag_dev, lab_f_dev, valid_t, edge_t, props_t, pk_f, nl_f, P, _s2d.BOUNDARY_SEGMENT_ENGINE))
    for k in core:
        core[k][flagged] = core_f[k]
    n_labels[flagged] = nl_f
    peak_sat[flagged] = sat_f
    for j, s in enumerate(flagged):
        local_maxima[s] = lm_f[j]
    if isinstance(labels_b, np.ndarray):
        labels_b[flagged] = lab_f
    else:
        labels_b = labels_b.index_put((idx,), lab_f_dev)
    return n_labels, peak_sat, labels_b


def _run_sweep(engine, lnpi_dev, seg, core, inputs, fp, nnebr, P, prop_names, return_surfaces, tie_fallback):
    """The shared back half of the pore and joint sweeps: given stage 1's
    surfaces on the card (and, for the device engine, its watershed and
    per-phase outputs), bring the results to the host, run the host flood
    or the tie fallback where asked, and assemble the sweep's dict."""
    valid, valid_t, edge_t, props_t = inputs
    S = lnpi_dev.shape[0]
    if engine == "device":
        fetch = {k: seg[k] for k in ("n_labels", "peak_sat", "peak_rc", "elev_tie")} | core
        if return_surfaces:
            fetch |= {"lnpi": lnpi_dev, "labels": seg["labels"]}
        got = _fetch(fetch)
        core = {k: got[k] for k in core}
        n_labels = got["n_labels"].astype(np.int64)
        peak_sat, peak_rc, elev_tie = got["peak_sat"], got["peak_rc"], got["elev_tie"]
        local_maxima = [peak_rc[s, : n_labels[s]].astype(np.int64) for s in range(S)]
        lnpi_b, labels_b = (got["lnpi"], got["labels"]) if return_surfaces else (lnpi_dev, seg["labels"])
        flagged = np.flatnonzero(elev_tie)
        if tie_fallback and flagged.size:
            # flagged states are now reference-exact, so fail_code 4 is not
            # raised for them (elev_tie stays True for observability)
            n_labels, peak_sat, labels_b = _tie_fallback(flagged, lnpi_dev, inputs, fp, nnebr, P, core, n_labels, peak_sat, local_maxima, labels_b)
            tie_unresolved = np.zeros(S, dtype=bool)
        else:
            tie_unresolved = elev_tie
    else:
        # one download feeds the host flood; the labels go back up once for
        # stage 2 over every state
        lnpi_b = _fetch({"lnpi": lnpi_dev})["lnpi"]
        labels_b, n_labels, peak_lnpi, peak_sat, local_maxima = _segment_batch_host(_elevation_host(lnpi_b, valid), lnpi_b, valid, fp, nnebr, P)
        labels_dev = torch.as_tensor(labels_b, device=lnpi_dev.device)
        core = _fetch(_s2d.pore_phase_batch(lnpi_dev, labels_dev, valid_t, edge_t, props_t, peak_lnpi, n_labels, P, _s2d.BOUNDARY_SEGMENT_ENGINE))
        # the host flood IS the reference semantics, tie or not
        elev_tie = np.zeros(S, dtype=bool)
        tie_unresolved = elev_tie

    out = dict(core)
    ridge = np.where(out["phase_ok"], out["ridge_diff"], np.inf)
    out["ridge_ok"] = np.all(ridge >= _PORE_CUTOFF, axis=1)
    out["fail_code"] = np.select(
        [peak_sat, n_labels == 0, tie_unresolved, ~out["ridge_ok"]],
        [np.int32(3), np.int32(2), np.int32(4), np.int32(1)],
        default=np.int32(0),
    ).astype(np.int32)
    out["elev_tie"] = np.asarray(elev_tie, dtype=bool)
    out["prop_names"] = prop_names
    out["n_phases"] = n_labels
    out["lnpi"] = lnpi_b
    out["labels"] = labels_b
    out["local_maxima"] = local_maxima
    return out


def _join(outs: list) -> dict:
    """Per-shard sweep dicts joined along the state axis: numpy arrays
    concatenated on the host, tensors on the first shard's device,
    local_maxima lists chained."""
    if len(outs) == 1:
        return outs[0]
    out = {}
    for k, v in outs[0].items():
        if k == "prop_names":
            out[k] = v
        elif k == "local_maxima":
            out[k] = [lm for o in outs for lm in o[k]]
        elif torch.is_tensor(v):
            out[k] = torch.cat([o[k].to(v.device) for o in outs])
        else:
            out[k] = np.concatenate([o[k] for o in outs])
    return out


def _sharded_sweep(devs, states, hd, valid, edge_idx, segment_engine, stage1, fp, nnebr, P, return_surfaces, tie_fallback):
    """The pore and joint sweeps over S states split into one contiguous
    block per device: stage 1 (the device engine's whole sweep) of every
    block is queued first, each under its device, then each block's back
    half (_run_sweep) runs, and the blocks are joined.  ``states`` are the
    per-state host arrays; stage1(dev, inputs, engine, *blocks) returns
    (lnpi_dev, seg, core)."""
    n = len(devs)
    blocks = [_blocks(a, n) for a in states]
    inputs, staged = {}, []
    for i, d in enumerate(devs[: len(blocks[0])]):
        if d not in inputs:  # the surface and its properties go to each device once
            inputs[d] = _props_inputs(hd, valid, edge_idx, d)
        engine = _resolve_segment_engine(segment_engine, d)
        with _on(d):
            staged.append((d, engine, stage1(d, inputs[d][1], engine, *(b[i] for b in blocks))))
    outs = []
    for d, engine, (lnpi_dev, seg, core) in staged:
        prop_names, inp = inputs[d]
        with _on(d):
            outs.append(_run_sweep(engine, lnpi_dev, seg, core, inp, fp, nnebr, P, prop_names, return_surfaces, tie_fallback))
    return _join(outs)


def _props_inputs(hd, valid, edge_idx, dev):
    """(prop_names, (valid, valid, edge_idx, props) with the last three on
    the card) of a made joint histogram's data."""
    prop_names = list(hd["props"])
    props = np.stack([np.asarray(hd["props"][p], dtype=np.float64) for p in prop_names])
    return prop_names, (valid, torch.as_tensor(valid, device=dev), torch.as_tensor(edge_idx, device=dev), torch.as_tensor(props, device=dev))


def pore_state_sweep(
    joint_hist, fh, p_vals, beta_vals, A, nnebr=1, max_peaks=10, mesh=None,
    segment_engine="auto", return_surfaces=True, tie_fallback=False, device=None,
):
    """Phase analysis of lnPI(h, N_tot) over S pore state points.

    Parameters
    ----------
    joint_hist : two_dim.joint_hist (made or unmade)
    fh         : F(h) callable (free_energy_profile.*)
    p_vals     : f64[S] total pressures
    beta_vals  : f64[S] inverse temperatures (paired with p_vals)
    A          : cross-sectional area
    nnebr, max_peaks : segmentation knobs (pore_hist.phase_average)
    mesh       : a parallel.grid_mesh; the S states are split into one
                 contiguous block per mesh device (both axes flattened)
                 and each block runs this sweep on its device (the
                 device stages of every block are queued first); states
                 are independent, so the outputs are the one-device
                 sweep's.  Give ``mesh`` or ``device``, not both.
    segment_engine : "auto" | "device" | "host" — "device" runs the whole
                 sweep (surfaces + watershed + phase analysis) on the card
                 via the fixed-shape steepest-ascent watershed
                 (segment2d.hillclimb_segment); "host" is the
                 reference-exact priority flood (imaging.py).  They agree
                 exactly on tie-free surfaces while the peak slots do not
                 saturate; "auto" = device on the card, host on the CPU.
    return_surfaces : when False the [S, H, N] ``lnpi``/``labels`` of the
                 device engine stay tensors on the card instead of being
                 copied to numpy — state sweeps consume the small per-phase
                 outputs only.  (The host engine returns numpy surfaces
                 anyway: it brings them to the host for the flood.)
    tie_fallback : device engine only — when True, states whose surface
                 has an exact elevation tie inside the footprint window
                 (elev_tie, the one regime where the device watershed and
                 the reference flood legally diverge) are re-run through
                 the reference-exact host flood + stage 2 on the card and
                 spliced over the device results; fail_code 4 is then
                 never raised.  When False (default) flagged states keep
                 the device answer and report fail_code 4.
    device     : where the numerics run without a mesh; None means the
                 CUDA card and raises where there is none (pass
                 ``device="cpu"`` for the CPU)

    Returns a dict of slot-padded host arrays (P = max_peaks + 1 slots):
      prop_names   list[K]
      ave          f64[S, P, K]   per-phase probability averages
      fe           f64[S, P]      F.E./kT per phase
      act_kT       f64[S, P, P]   activation free energies
      act_kT_diff  f64[S, P, P]
      ts, ridge_diff, peak_flat   segment2d.pore_phase_batch's
      n_phases     i64[S]         live watershed phases per state
      phase_ok     bool[S, P]     slot validity
      ridge_ok     bool[S]        no ridgeline effects in any live phase
      fail_code    i32[S]         per-state failure reason (the class
                                  path raises per state, pore_hist.py
                                  "Cannot segment"/"ridgeline effects";
                                  the batched sweep reports instead):
                                  0 ok / 1 ridge-unsafe / 2 no peaks
                                  found (segmentation empty) / 3 peak
                                  slots saturated (more maxima than the
                                  max_peaks+1 padding — raise max_peaks)
                                  / 4 exact elevation tie on the device
                                  engine without tie_fallback (labels may
                                  legally differ from the reference
                                  flood — re-run with tie_fallback=True
                                  or segment_engine="host")
      elev_tie     bool[S]        device engine's per-state tie detector
                                  (informational even when tie_fallback
                                  resolved it; always False on the host
                                  engine, whose flood IS the reference)
      lnpi         f64[S, H, N]   normalized surfaces
      labels       i32[S, H, N]   watershed labels
      local_maxima list[S] of i64[n_phases_s, 2] peak coordinates
    """
    devs = _devices(mesh, device)
    # a made histogram (or from_json load) is used read-only; only an
    # unmade one needs the deepcopy that shields the caller from make()'s
    # in-place assembly
    jh = joint_hist
    if "ln(PI)" not in jh.data:
        jh = copy.deepcopy(joint_hist)
        jh.make()
    hd = jh.data
    assert np.all(hd["op_2"] == np.arange(len(hd["op_2"]))), "Must be 0 <= N <= N_max in a continuous fashion"
    assert np.all(hd["bounds_idx"][:, 0] == 0), "Lower bound for N must start from 0"
    edge_idx = np.array(hd["bounds_idx"][:, 1], dtype=int)

    p_vals = np.asarray(p_vals, dtype=np.float64)
    beta_vals = np.asarray(beta_vals, dtype=np.float64)
    assert p_vals.shape == beta_vals.shape and p_vals.ndim == 1, "p_vals/beta_vals must be matching 1-D state lists"

    lnpi_raw = np.asarray(hd["ln(PI)"], dtype=np.float64)
    H, N = lnpi_raw.shape
    h_vals = np.asarray(hd["op_1"], dtype=np.float64)
    fh_vals = np.array([fh(h) for h in h_vals], dtype=np.float64)
    valid = np.arange(N)[None, :] <= edge_idx[:, None]  # segment2d.valid_mask_2d

    P = max_peaks + 1  # background slot convention of pore_hist.phase_average
    fp = _footprint(H, N, nnebr)

    def stage1(dev, inputs, engine, p_b, beta_b):
        args = [torch.as_tensor(a, device=dev) for a in (lnpi_raw, h_vals, fh_vals, p_b)] + [float(A), torch.as_tensor(beta_b, device=dev), inputs[1]]
        if engine == "device":
            return _s2d.pore_sweep_fused(*args, inputs[2], inputs[3], tuple(fp.shape), P, boundary_engine=_s2d.BOUNDARY_SEGMENT_ENGINE)
        return _s2d.pore_surface_batch(*args)[0], None, None

    return _sharded_sweep(devs, (p_vals, beta_vals), hd, valid, edge_idx, segment_engine, stage1, fp, nnebr, P, return_surfaces, tie_fallback)
