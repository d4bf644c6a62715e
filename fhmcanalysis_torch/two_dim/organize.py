"""Track phases across a mu_1 reweighting sweep for a pore.

Parity: the reference's moments/histogram/two_dim/h_ntot/organize.pyx —
phases are matched to previous records by nearest (h, N) peak within a
cutoff on scaled axes; translation tables remap activation matrices.

The PyTorch port's copy of the JAX package's ``two_dim/organize.py``
(host-only).
"""

from __future__ import annotations

import json

import numpy as np

__all__ = ["phase_organizer"]


class phase_organizer(object):
    """Organize per-step phase properties into consistent trackers
    (organize.pyx:23-192)."""

    def __init__(self, axes_ratio, nPix, max_phases):
        self.axes_ratio = axes_ratio
        self.nPix = nPix
        self.rcut2 = nPix**2
        self.phase_data = []
        self.last_pt = []
        self.dF_kT = []
        self.dF_kT_diff = []
        self.max_phases = max_phases
        self.max_err = 0.0

    def add(self, info):
        """Record one sweep step's phase properties (organize.pyx:61-99).

        info = (mu1, P, ntot[], x[], u[], fe[], peak_pt[], ave_h[],
        act[], act_diff[]) over phases.
        """
        translation = {}
        mu1, P, _phaseNtot, _phaseX, _phaseU, _phaseFreeEnergy, _phasePt, _phaseAveH, _phaseAct, _phaseActDiff = info
        used = {}
        for phase in range(len(_phasePt)):
            if _phaseFreeEnergy[phase] != np.inf and len(_phasePt[phase]) > 0:
                idx = self.get_phase(_phasePt[phase])
                assert idx < self.max_phases, (
                    "Too many phases (%d) have appeared for phase_organizer to handle (max = %d)"
                    % (idx, self.max_phases)
                )
                if idx in used:
                    raise Exception(
                        "Phase organizer wants to assign different calculated phases to same internally "
                        "stored phase, try reducing rcut and increasing max_phases"
                    )
                used[idx] = 1
                translation[phase] = idx

        dF_kT = np.zeros((self.max_phases, self.max_phases))
        dF_kT_diff = np.zeros((self.max_phases, self.max_phases))
        for p1 in range(len(_phaseAct)):
            for p2 in range(p1 + 1, len(_phaseAct)):
                if p1 in translation and p2 in translation:
                    dF_kT[translation[p1]][translation[p2]] = _phaseAct[p1][p2]
                    dF_kT[translation[p2]][translation[p1]] = _phaseAct[p2][p1]
                    dF_kT_diff[translation[p1]][translation[p2]] = _phaseActDiff[p1][p2]
                    dF_kT_diff[translation[p2]][translation[p1]] = _phaseActDiff[p2][p1]

        for phase in translation:
            self.add_data(
                (
                    mu1,
                    P,
                    _phaseNtot[phase],
                    _phaseX[phase],
                    _phaseU[phase],
                    _phaseFreeEnergy[phase],
                    _phasePt[phase],
                    _phaseAveH[phase],
                    dF_kT[translation[phase]],
                    dF_kT_diff[translation[phase]],
                ),
                translation[phase],
            )

    def add_data(self, info, phase_idx):
        """Append one phase record (organize.pyx:101-118)."""
        assert phase_idx < self.max_phases, (
            "Too many phases (%d) have been identified for phase_organizer to handle (max = %d)"
            % (phase_idx, self.max_phases)
        )
        if len(self.phase_data) > phase_idx:
            self.phase_data[phase_idx].append(info)
        else:
            self.phase_data.append([info])

    def get_phase(self, phasePt):
        """Internal index for a phase by nearest previous peak within rcut
        (organize.pyx:120-162)."""
        if len(self.last_pt) == 0:
            self.last_pt.append(phasePt)
            return 0

        idx = 0
        d2 = np.inf
        for i in range(len(self.last_pt)):
            dist2 = (self.last_pt[i][0] - phasePt[0]) ** 2 + ((self.last_pt[i][1] - phasePt[1]) * self.axes_ratio) ** 2
            if dist2 < d2:
                idx = i
                d2 = dist2

        if d2 > self.rcut2:
            if len(self.last_pt) < self.max_phases:
                self.last_pt.append(phasePt)
                return len(self.last_pt) - 1
            self.max_err = max(self.max_err, np.sqrt(d2))
            self.last_pt[idx] = phasePt
            return idx
        self.last_pt[idx] = phasePt
        return idx

    def print_org(self, prefix, comments=""):
        """Write the tracker report to prefix.json (organize.pyx:164-192)."""
        max_observed_phase = len(self.last_pt)
        obj = {"Comments": comments, "Max Guessing Err": self.max_err}
        for i in range(len(self.phase_data)):
            rows = self.phase_data[i]
            info = {
                "Phase": i,
                "mu_1": [r[0] for r in rows],
                "P": [r[1] for r in rows],
                "N_tot": [r[2] for r in rows],
                "U_tot": [r[4] for r in rows],
                "Free_energy/kT": [r[5] for r in rows],
                "<h>": [r[7] for r in rows],
                "x_i": [np.asarray(r[3]).tolist() for r in rows],
                "(h,N)": [[r[6][0], r[6][1]] for r in rows],
                "dF^t_i,j(integral)": [np.asarray(r[8][:max_observed_phase]).tolist() for r in rows],
                "dF^t_i,j(diff)": [np.asarray(r[9][:max_observed_phase]).tolist() for r in rows],
            }
            obj[str(i)] = info  # string keys: py3 json can't sort mixed int/str
        with open(prefix + ".json", "w") as f:
            json.dump(obj, f, sort_keys=True, indent=4)
