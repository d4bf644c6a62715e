"""Slit-pore joint histogram lnPI(h, N_tot) with watershed phase analysis.

The PyTorch port of the JAX package's ``two_dim/pore_hist.py``.  Parity
target: the reference's moments/histogram/two_dim/h_ntot/pore_hist.pyx.  The reference module is untested upstream and ships
several latent faults; this rebuild implements the documented intent and
notes each deviation:

  - the valid-region mask is built AFTER the lnPI surface exists
    (reference reads self.data['ln(PI)'] before creating it, :128)
  - boolean masking uses ~mask (reference writes ``lp[not mask]``,
    :172-174, a ValueError on arrays)
  - ridge values index edge_idx per-row (:231 indexes with the whole
    array) and the activation diff uses ln(PI) (:246 indexes self.data
    with an integer)
  - the background of the shifted surface is zeroed via ~mask
    (:413 zeroes the valid region instead)

Engines: ``engine="device"`` (default) routes surface build,
normalization, per-phase probability averages, and the transition-state
boundary integrals through the 2-D core (core/segment2d.py) on the
histogram's ``device`` (the CUDA card unless the constructor is given
``device="cpu"``) — watershed seeding/labeling and the line profiles stay
on host (imaging.py).  ``engine="numpy"`` is the pure-host oracle the
equivalence suite checks the device path against at 1e-12.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from ..core import segment2d as _s2d
from ..core.state import _device
from .imaging import find_boundaries, peak_local_max, profile_line, watershed

__all__ = ["pore_hist"]

_BIGNEG = -1.7976931348623157e308  # -sys.float_info.max, reference sentinel


def _np(t) -> np.ndarray:
    """A writable host numpy copy of a tensor."""
    return t.detach().cpu().numpy().copy()


def _logsumexp(vals):
    vals = np.asarray(vals, dtype=np.float64)
    m = np.max(vals)
    if not np.isfinite(m):
        return m
    return m + np.log(np.sum(np.exp(vals - m)))


class pore_hist(object):
    """lnPI(h, N_tot) for slit pores (pore_hist.pyx:82-477)."""

    def __init__(self, joint_hist, fh, p_tot, A, beta, engine="device", device=None):
        """joint_hist: assembled joint histogram; fh: F(h) callable;
        p_tot: total pressure; A: cross-sectional area; beta: 1/kT;
        engine: "device" (the 2-D core on ``device``) or "numpy" (host
        oracle); device: where the device engine runs, None means the CUDA
        card and raises where there is none (unused by "numpy")."""
        assert engine in ("device", "numpy"), "Unknown engine: %s" % engine
        self.clear()
        self.engine = engine
        self.device = _device(device) if engine == "device" else None
        self.data["F(h)"] = fh
        self.data["p"] = p_tot
        self.data["hist"] = copy.deepcopy(joint_hist)
        self.data["A"] = A
        self.data["beta"] = beta

        try:
            self.data["hist"].make()
        except Exception as e:
            raise Exception("Could not construct joint histogram: %s" % e)

        hd = self.data["hist"].data
        assert np.all(hd["op_2"] == np.arange(len(hd["op_2"]))), "Must be 0 <= N <= N_max in a continuous fashion"
        assert np.all(hd["bounds_idx"][:, 0] == 0), "Lower bound for N must start from 0"
        self.data["edge_idx"] = np.array(hd["bounds_idx"][:, 1], dtype=int)

        # build lnPI(h, N): shift each row by -beta*(F(h) + p*A*h) - lnPI[h,0]
        # (pore_hist.pyx:131-135), THEN derive the valid mask
        if self.engine == "device":
            fh_vals = np.array([self.data["F(h)"](h) for h in hd["op_1"]], dtype=np.float64)
            self.data["ln(PI)"] = _np(
                _s2d.build_pore_lnpi(self._dev(hd["ln(PI)"]), self._dev(hd["op_1"]), self._dev(fh_vals), float(p_tot), float(A), float(beta))
            )
        else:
            self.data["ln(PI)"] = np.array(hd["ln(PI)"], dtype=np.float64, copy=True)
            for i in range(len(hd["op_1"])):
                h = hd["op_1"][i]
                shift = -self.data["beta"] * (self.data["F(h)"](h) + self.data["p"] * self.data["A"] * h) - self.data[
                    "ln(PI)"
                ][i, 0]
                self.data["ln(PI)"][i, :] += shift
        self.data["mask"] = self.data["ln(PI)"] > -np.inf
        self.normalize()

    def clear(self):
        self.data = {}

    def _dev(self, x, dtype=torch.float64):
        """x as a tensor on the histogram's device."""
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=self.device)

    def _valid(self):
        """bool[H, N] ragged valid region col <= edge_idx[row]."""
        return np.arange(self.data["ln(PI)"].shape[1])[None, :] <= self.data["edge_idx"][:, None]

    def _props_stack(self):
        """Stacked [K, H, N] property surfaces in dict order."""
        props = self.data["hist"].data["props"]
        names = list(props)
        return names, np.stack([np.asarray(props[p], dtype=np.float64) for p in names])

    def normalize(self):
        """Masked 2-D normalization over the ragged valid region
        (pore_hist.pyx:57-80, 146-152)."""
        lnpi = self.data["ln(PI)"]
        if self.engine == "device":
            self.data["ln(PI)"] = _np(_s2d.normalize_2d(self._dev(lnpi), self._dev(self._valid(), torch.bool)))
            return
        vals = [lnpi[i, : self.data["edge_idx"][i] + 1] for i in range(len(lnpi))]
        shift = _logsumexp(np.concatenate(vals))
        self.data["ln(PI)"] = lnpi - shift

    def thermo(self, mask):
        """Probability-averaged properties over a masked region
        (pore_hist.pyx:154-184)."""
        if self.engine == "device":
            names, stacked = self._props_stack()
            ave, lp = _s2d.region_thermo_2d(self._dev(self.data["ln(PI)"]), self._dev(mask, torch.bool), self._dev(stacked))
            ave, lp = _np(ave), _np(lp)
            ave_props = {name: ave[k] for k, name in enumerate(names)}
            ave_props["peak_idx"] = np.where(lp == np.max(lp))
            return ave_props

        lp = np.array(self.data["ln(PI)"], copy=True)
        lp -= np.max(lp[mask]) if np.any(mask) else 0.0
        lp[~mask] = -np.inf
        with np.errstate(under="ignore"):
            lp -= _logsumexp(lp[np.isfinite(lp)])
        lp[~mask] = -np.inf

        with np.errstate(under="ignore"):
            prob = np.exp(np.where(np.isfinite(lp), lp, -np.inf))
        sum_prob = np.sum(prob)

        ave_props = {}
        for prop in self.data["hist"].data["props"]:
            ave_props[prop] = np.sum(prob * self.data["hist"].data["props"][prop]) / sum_prob
        ave_props["peak_idx"] = np.where(lp == np.max(lp))
        return ave_props

    def phase_average(self, nnebr=1, max_peaks=10):
        """Per-watershed-label phase properties + activation free energies
        (pore_hist.pyx:186-252)."""
        if self.engine == "device":
            return self._phase_average_device(nnebr, max_peaks)
        pore_cutoff = 10.0
        self.normalize()
        max_peaks += 1  # to account for background
        try:
            self._segment(nnebr, max_peaks)
        except Exception as e:
            raise Exception("Cannot segment the surface: %s" % e)

        uniqueMax = np.unique(self.data["seg"]["phase_labels"])
        ln_f = _logsumexp(self.data["ln(PI)"][:, 0])

        ts = self.data["seg"]["transition_state_kT"]
        live = ts > _BIGNEG
        ts[live] -= ln_f
        ts[live] *= -1.0

        phase_props = {}
        ctr = 0
        for hill in uniqueMax:
            if hill < 1:
                continue
            mask = self.data["seg"]["phase_labels"] == hill
            ave_props = self.thermo(mask)
            ave_props["F.E./kT"] = ln_f - _logsumexp(self.data["ln(PI)"][mask])
            phase_props[ctr] = copy.deepcopy(ave_props)
            ctr += 1

            # ridgeline-effect guard (intended form of pore_hist.pyx:230-234)
            ridge_vals = [
                self.data["ln(PI)"][h, self.data["edge_idx"][h]]
                if mask[h, self.data["edge_idx"][h]]
                else -np.inf
                for h in range(len(self.data["edge_idx"]))
            ]
            max_diff = np.max(self.data["ln(PI)"][mask]) - np.max(ridge_vals)
            if max_diff < pore_cutoff:
                raise Exception("Cannot compute phase_average because of ridgeline effects")

        return self._finish_phase_average(phase_props, uniqueMax, ts)

    def _phase_average_device(self, nnebr=1, max_peaks=10):
        """Device form of phase_average: one fused call on the device
        (core/segment2d.pore_phase_core) computes every per-phase
        average, free energy, and ridge diagnostic; host keeps watershed
        and the dict/exception glue (pore_hist.pyx:186-252)."""
        pore_cutoff = 10.0
        self.normalize()
        max_peaks += 1
        try:
            self._segment(nnebr, max_peaks)
        except Exception as e:
            raise Exception("Cannot segment the surface: %s" % e)

        labels = self.data["seg"]["phase_labels"]
        lm = self.data["seg"]["local_maxima"]
        uniqueMax = np.unique(labels)
        n_max = len(lm)
        lnpi = self.data["ln(PI)"]
        ln_f = _logsumexp(lnpi[:, 0])

        ts = self.data["seg"]["transition_state_kT"]
        live = ts > _BIGNEG
        ts[live] -= ln_f
        ts[live] *= -1.0

        if n_max == 0:
            return self._finish_phase_average({}, uniqueMax, ts)

        names, stacked = self._props_stack()
        peak_lnpi = lnpi[lm[:, 0], lm[:, 1]]
        core = _s2d.pore_phase_core(
            self._dev(lnpi),
            self._dev(labels, torch.int32),
            self._dev(self._valid(), torch.bool),
            self._dev(self.data["edge_idx"], torch.int64),
            self._dev(stacked),
            self._dev(peak_lnpi),
            n_max,
            n_max,
            boundary_engine=_s2d.BOUNDARY_SEGMENT_ENGINE,
        )
        ave, fe, ridge_diff = _np(core["ave"]), _np(core["fe"]), _np(core["ridge_diff"])

        phase_props = {}
        ctr = 0
        for hill in uniqueMax:
            if hill < 1:
                continue
            s = int(hill) - 1
            ave_props = {name: ave[s, k] for k, name in enumerate(names)}
            tmp = np.where(labels == hill, lnpi, -np.inf)
            ave_props["peak_idx"] = np.where(tmp == np.max(tmp))
            ave_props["F.E./kT"] = fe[s]
            phase_props[ctr] = ave_props
            ctr += 1
            if ridge_diff[s] < pore_cutoff:
                raise Exception("Cannot compute phase_average because of ridgeline effects")

        return self._finish_phase_average(phase_props, uniqueMax, ts)

    def _finish_phase_average(self, phase_props, uniqueMax, ts):
        """Activation free-energy matrices from the transition states
        (pore_hist.pyx:213-227); shared host epilogue of both engines."""
        n = len(uniqueMax)
        act_kT = np.zeros((n - 1, n - 1))
        act_kT_diff = np.zeros((n - 1, n - 1))
        lm = self.data["seg"]["local_maxima"]
        lnpi = self.data["ln(PI)"]
        for i in range(1, n):
            for j in range(i + 1, n):
                if ts[i, j] > _BIGNEG:
                    act_kT[i - 1, j - 1] = ts[i, j] - max(
                        phase_props[i - 1]["F.E./kT"], phase_props[j - 1]["F.E./kT"]
                    )
                    act_kT[j - 1, i - 1] = act_kT[i - 1, j - 1]
                    act_kT_diff[i - 1, j - 1] = (
                        min(lnpi[lm[i - 1, 0], lm[i - 1, 1]], lnpi[lm[j - 1, 0], lm[j - 1, 1]])
                        - self.data["seg"]["max_border_kT"][i, j]
                    )
                    act_kT_diff[j - 1, i - 1] = act_kT_diff[i - 1, j - 1]

        phase_props["activation_kT"] = act_kT
        phase_props["activation_kT_diff"] = act_kT_diff
        return phase_props

    def width_phase_average(self, h_divide, nnebr=1, max_peaks=10):
        """Merge watershed hills into h-divided super-phases and average
        (pore_hist.pyx:254-317)."""
        pore_cutoff = 10.0
        h_divide = np.asarray(sorted(h_divide), dtype=np.float64)
        assert max_peaks > len(h_divide), "Cannot create that many phases when expecting less local maxima in ln(PI)"

        self.normalize()
        max_peaks += 1
        try:
            self._segment(nnebr, max_peaks)
            assign = self._collect(h_divide)
        except Exception as e:
            raise Exception("Cannot segment the surface: %s" % e)

        ln_f = _logsumexp(self.data["ln(PI)"][:, 0])
        ts = self.data["seg"]["transition_state_kT"]
        live = ts > _BIGNEG
        ts[live] -= ln_f
        ts[live] *= -1.0

        phase_props = {}
        for i in sorted(assign):
            assert len(assign[i]) > 0, "Width-defined phase does not contain any local maxima in ln(PI)"
            mask = None
            for hill in assign[i]:
                m = self.data["seg"]["phase_labels"] == hill
                mask = m if mask is None else (mask | m)

            ave_props = self.thermo(mask)
            ave_props["F.E./kT"] = ln_f - _logsumexp(self.data["ln(PI)"][mask])
            phase_props[i] = copy.deepcopy(ave_props)

            ridge_vals = [
                self.data["ln(PI)"][h, self.data["edge_idx"][h]]
                if mask[h, self.data["edge_idx"][h]]
                else -np.inf
                for h in range(len(self.data["edge_idx"]))
            ]
            max_diff = np.max(self.data["ln(PI)"][mask]) - np.max(ridge_vals)
            if max_diff < pore_cutoff:
                raise Exception("Cannot compute phase_average because of ridgeline effects")

        return phase_props

    def _collect(self, h_divide):
        """Group watershed hills into super-phases by the h coordinate of
        their peaks (pore_hist.pyx:319-375)."""
        h_div = sorted(h_divide)
        h_idx = np.zeros(len(h_div), dtype=int)

        h_ctr = 0
        op1 = self.data["hist"].data["op_1"]
        for i in range(len(op1)):
            if h_ctr < len(h_div) and op1[i] > h_div[h_ctr]:
                h_idx[h_ctr] = i - 1
                h_ctr += 1
        if h_ctr == len(h_div) - 1:
            h_idx[h_ctr] = len(op1) - 1
        elif h_ctr < len(h_div) - 1:
            raise Exception("Unable to divide h-space")

        assign = {}
        uniqueMax = np.unique(self.data["seg"]["phase_labels"])
        for hill in uniqueMax:
            if hill < 1:
                continue
            mask = self.data["seg"]["phase_labels"] == hill
            tmp = np.array(self.data["ln(PI)"], copy=True)
            tmp[~mask] = -np.inf
            h_loc = np.where(tmp == np.max(tmp))[0][0]

            phase = 0
            while h_loc > h_idx[phase]:
                phase += 1
            assign.setdefault(phase, []).append(hill)

        for phase in range(len(h_idx)):
            assign.setdefault(phase, [])
        return assign

    def _segment(self, nnebr=1, num_peaks=10):
        """Watershed segmentation of the lnPI surface with scaled
        footprint, boundary transition-state integration, and free-energy
        line profiles between maxima (pore_hist.pyx:377-477).

        Peak finding, the flood itself, and the line profiles run on host
        (imaging.py, native C++ flood); with engine="device" the
        boundary transition-state integration runs on the device
        (core/segment2d.boundary_pair_integrals).
        """
        self.data["seg"] = {}

        sd = self.data["ln(PI)"]
        len_H, len_N = sd.shape
        n_incrs = float(len_N - 1)
        h_incrs = float(len_H - 1)

        if h_incrs >= n_incrs:
            scale_h, scale_n = 1.0, h_incrs / n_incrs
        else:
            scale_h, scale_n = n_incrs / h_incrs, 1.0

        fp_x = int(np.round(scale_n * nnebr)) * 2 + 1
        fp_y = int(np.round(scale_h * nnebr)) * 2 + 1
        footprint = np.ones((fp_x, fp_y))

        # shift valid pixels >= 0, background exactly 0 (intended form of
        # pore_hist.pyx:412-413)
        mask = self.data["mask"]
        x = sd - np.min(sd[mask])
        x[~mask] = 0.0

        lm = peak_local_max(x, min_distance=nnebr, exclude_border=0, num_peaks=num_peaks, footprint=footprint)
        self.data["seg"]["local_maxima"] = lm
        n_maxima = len(lm)

        markers = np.zeros((len_H, len_N), dtype=int)
        for i in range(n_maxima):
            markers[lm[i][0], lm[i][1]] = i + 1

        ans = watershed(-x, markers=markers, mask=mask, connectivity=footprint)
        self.data["seg"]["phase_labels"] = ans

        # integrate lnPI along phase boundaries
        if self.engine == "device":
            min_df, max_val = _s2d.boundary_pair_integrals(
                self._dev(sd), self._dev(ans, torch.int32), max_labels=n_maxima, engine=_s2d.BOUNDARY_SEGMENT_ENGINE
            )
            min_df, max_val = _np(min_df), _np(max_val)
        else:
            min_df = np.full((n_maxima + 1, n_maxima + 1), _BIGNEG)
            max_val = np.full((n_maxima + 1, n_maxima + 1), _BIGNEG)
            my_edges = find_boundaries(self.data["seg"]["phase_labels"], connectivity=1, mode="inner", background=0)
            ix, iy = np.where(my_edges)
            pl = self.data["seg"]["phase_labels"]
            nebr_vecs = [[1, 1], [1, 0], [1, -1], [0, -1], [-1, -1], [-1, 0], [-1, 1], [0, 1]]
            for i, j in zip(ix, iy):
                this_phase = pl[i][j]
                for k, m in nebr_vecs:
                    if 0 <= i + k < len_H and 0 <= j + m < len_N:
                        nebr_phase = pl[i + k, j + m]
                        if nebr_phase != this_phase and nebr_phase > 0 and this_phase > 0:
                            ave_val = np.logaddexp(sd[i, j] - np.log(2.0), sd[i + k, j + m] - np.log(2.0))
                            min_df[this_phase, nebr_phase] = np.logaddexp(min_df[this_phase, nebr_phase], ave_val)
                            min_df[nebr_phase, this_phase] = min_df[this_phase, nebr_phase]
                            max_val[this_phase, nebr_phase] = max(max_val[this_phase, nebr_phase], ave_val)
                            max_val[nebr_phase, this_phase] = max_val[this_phase, nebr_phase]

        self.data["seg"]["transition_state_kT"] = min_df
        self.data["seg"]["max_border_kT"] = max_val

        # free-energy profiles along lines chaining (0,0) -> maxima -> (H,N)
        start = [(0, 0)]
        end = []
        order = np.lexsort((lm[:, 1], lm[:, 0])) if n_maxima else np.array([], dtype=int)
        for i in range(n_maxima):
            start.append((lm[order][i][0], lm[order][i][1]))
            end.append((lm[order][i][0], lm[order][i][1]))
        end.append((len_H, len_N))

        line_profile = np.array([])
        line_profile_coords = []
        for i in range(len(start)):
            intensity = profile_line(x, start[i], end[i], linewidth=1, order=0, cval=0.0)
            dh = (end[i][0] - start[i][0]) / float(len(intensity))
            dn = (end[i][1] - start[i][1]) / float(len(intensity))
            if i == 0:
                line_profile = np.concatenate((line_profile, intensity))
                for j in range(len(intensity)):
                    line_profile_coords.append([start[i][0] + dh * j, start[i][1] + dn * j])
            else:
                line_profile = np.concatenate((line_profile, intensity[1:]))
                for j in range(1, len(intensity)):
                    line_profile_coords.append([start[i][0] + dh * j, start[i][1] + dn * j])

        self.data["seg"]["line_profile"] = line_profile + np.min(sd[mask])
        self.data["seg"]["line_profile_coords"] = np.array(line_profile_coords)
