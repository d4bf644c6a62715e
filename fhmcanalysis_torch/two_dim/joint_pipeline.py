"""Batched pipeline over a joint (N_1, N_tot) GC surface.

The PyTorch port of the JAX package's ``two_dim/joint_pipeline.py``.  A
capability beyond the reference: joint_hist.pyx (:22-301) only assembles
and persists the 2-D surface — it has no thermo.  This module gives the
assembled surface the treatment the slit-pore surface gets
(pore_pipeline.py): S (mu_1, mu_2) state points are reweighted and
normalized on the card, segmented by the device watershed or the host
flood, and integrated per phase (probability averages, free energies,
ridge diagnostics, transition states) for all S states at once.

Conventions (documented deviations, no upstream analog to mirror):
  - reweight rule: lnPI'(i,j) = lnPI(i,j) + beta*(dmu1*N1[i] + dmu2*N2)
    with N2 = op_2[j] - op_1[i] — the binary-system GC identity, the 2-D
    form of gc_hist.pyx:377-406.
  - F.E./kT per phase = ln_f - lse(lnPI | phase) with ln_f the logsumexp
    of column op_2[0] (for a joint hist starting at N_tot = 0 this is
    the empty-system reference, matching the 1-D lnPI[0] convention).
  - the valid region is data-driven (isfinite of the assembled surface),
    so interior holes from non-contiguous op_2 entries are excluded.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from ..core import segment2d as _s2d
from ..utils import profiling
from .pore_pipeline import _devices, _footprint, _sharded_sweep

__all__ = ["joint_state_sweep"]


@profiling.spanned("fhmc.entry.joint_sweep")
def joint_state_sweep(
    joint_hist, beta, mu_ref, mu_targets, nnebr=1, max_peaks=10, mesh=None,
    segment_engine="auto", return_surfaces=True, tie_fallback=False, device=None,
):
    """Phase analysis of lnPI(N_1, N_tot) over S chemical-potential targets.

    Parameters
    ----------
    joint_hist : two_dim.joint_hist (made or unmade), rows = N_1 values,
                 columns = N_tot values (op_2 must contain the N_1 range)
    beta       : inverse temperature the surface was sampled at
    mu_ref     : (mu_1, mu_2) of the sampled surface
    mu_targets : f64[S, 2] absolute (mu_1, mu_2) targets
    nnebr, max_peaks : segmentation knobs (pore_hist.phase_average
                 semantics; the footprint scales with the surface shape)
    mesh, segment_engine, return_surfaces, tie_fallback, device : the
                 state split over a parallel.grid_mesh, watershed engine,
                 surface-fetch, exact-elevation-tie-fallback and device
                 knobs, pore_state_sweep semantics ("device" = the
                 whole sweep on the card via the fixed-shape
                 steepest-ascent watershed; "host" = reference-exact
                 priority flood; "auto" = device on the card).

    Returns the pore_state_sweep dict schema (slot-padded, P =
    max_peaks + 1): prop_names, ave [S,P,K], fe [S,P], act_kT,
    act_kT_diff, n_phases, phase_ok, ridge_ok, fail_code (incl. code 4 =
    unresolved device-engine elevation tie), elev_tie, lnpi, labels,
    local_maxima.
    """
    devs = _devices(mesh, device)
    with profiling.span("fhmc.prologue.sweep2d"):
        # a made histogram (or from_json load) is used read-only; only an
        # unmade one needs the deepcopy that shields the caller from make()'s
        # in-place assembly
        jh = joint_hist
        if "ln(PI)" not in jh.data:
            jh = copy.deepcopy(joint_hist)
            jh.make()
        hd = jh.data

        lnpi_raw = np.asarray(hd["ln(PI)"], dtype=np.float64)
        H, N = lnpi_raw.shape
        assert H > 1 and N > 1, (
            "joint surface must span at least 2 N_1 values and 2 N_tot bins (got %d x %d)" % (H, N)
        )
        op1 = np.asarray(hd["op_1"], dtype=np.float64)
        op2 = np.asarray(hd["op_2"], dtype=np.float64)
        valid = np.isfinite(lnpi_raw)
        edge_idx = np.array(hd["bounds_idx"][:, 1], dtype=int)

        mu_targets = np.asarray(mu_targets, dtype=np.float64)
        assert mu_targets.ndim == 2 and mu_targets.shape[1] == 2, "mu_targets must be [S, 2] (mu_1, mu_2)"
        dmu1 = mu_targets[:, 0] - float(mu_ref[0])
        dmu2 = mu_targets[:, 1] - float(mu_ref[1])

        P = max_peaks + 1
        fp = _footprint(H, N, nnebr)

    def stage1(dev, inputs, engine, dmu1_b, dmu2_b):
        args = [torch.as_tensor(a, device=dev) for a in (lnpi_raw, op1, op2)] + [float(beta)] + [torch.as_tensor(a, device=dev) for a in (dmu1_b, dmu2_b)] + [inputs[1]]
        if engine == "device":
            return _s2d.joint_sweep_fused(*args, inputs[2], inputs[3], tuple(fp.shape), P, boundary_engine=_s2d.BOUNDARY_SEGMENT_ENGINE)
        return _s2d.joint_surface_batch(*args)[0], None, None

    return _sharded_sweep(devs, (dmu1, dmu2), hd, valid, edge_idx, segment_engine, stage1, fp, nnebr, P, return_surfaces, tie_fallback)
