"""Grand-canonical 1-D histogram with N_tot as the order parameter.

Drop-in replacement for the reference's ntot engine
(moments/histogram/one_dim/ntot/gc_hist.pyx): same class name, method
names, argument orders, data-dict keys, and failure modes, so the
reference's workflows and tests transfer directly.  The PyTorch port's
copy of the JAX package's ``histogram/ntot.py``.

Architecture: this class is the *host compatibility shell*.  ``self.data``
holds numpy arrays, as in the JAX package; every numeric step
(normalize/reweight/derivatives/extrapolation/segmentation) builds the
port's ``Hist`` on the histogram's device (the CUDA card unless the
constructor is given ``device="cpu"``) and runs ``fhmcanalysis_torch.core``
on it.  Batched, device-resident workflows use the core API directly (see
``core.pipeline`` and ``binary.isopleth``).
"""

from __future__ import annotations

import copy

import numpy as np
import scipy.optimize
import torch

from .. import io as _io
from ..core import extrap as _extrap
from ..core import ops as _ops
from ..core import segment as _segment
from ..core.derivs import DerivEngine
from ..core.moments import mom_prod, order_mom_address
from ..core.state import Hist, HistMeta, _device, make_hist

__all__ = ["histogram", "phase_eq_error"]


def _np(t) -> np.ndarray:
    """A host numpy copy of a tensor."""
    return t.detach().cpu().numpy()


class histogram(object):
    """Reads a 1-D composite histogram (netCDF4) and computes thermodynamic
    properties by reweighting/extrapolation; N_tot is the order parameter.

    Parity: class histogram, ntot/gc_hist.pyx:80-2563.

    device: where the numerics run; None means the CUDA card and raises
    where there is none (pass ``device="cpu"`` for the CPU).
    """

    _OP_KEY = "ntot"  # data key holding the order parameter
    _NC_OP_NAME = "N_{tot}"

    def __init__(self, fname, beta_ref, mu_ref, smooth=0, ke=False, device=None):
        self._setup(fname, beta_ref, mu_ref, smooth, ke, device)
        self.reload()

    @classmethod
    def from_composite(cls, raw, beta_ref, mu_ref, smooth=0, ke=False, device=None):
        """A histogram from an in-memory composite (the ``read_composite``
        dict: lnpi, op, mom, history, volume, nspec, max_order and, where
        present, pk_hist / e_hist) through the same checks as a file load;
        ``metadata["fname"]`` is empty."""
        self = cls.__new__(cls)
        self._setup("", beta_ref, mu_ref, smooth, ke, device)
        self._take(raw)
        return self

    def _setup(self, fname, beta_ref, mu_ref, smooth, ke, device):
        self.device = _device(device)
        self.metadata = {}
        self.metadata["beta_ref"] = beta_ref
        if isinstance(mu_ref, (list, tuple, np.ndarray)):
            assert len(mu_ref) > 0, "Incomplete chemical potential information"
            self.metadata["mu_ref"] = np.array(mu_ref, dtype=np.float64)
        elif isinstance(mu_ref, (float, int, np.floating, np.integer)):
            self.metadata["mu_ref"] = np.array([mu_ref], dtype=np.float64)
        else:
            raise Exception("Unrecognized type for mu_ref")
        self.metadata["nspec"] = len(self.metadata["mu_ref"])
        assert self.metadata["beta_ref"] > 0, "Illegal beta value"
        self.metadata["smooth"] = smooth
        assert self.metadata["smooth"] >= 0, "Illegal smooth value"
        assert isinstance(fname, str), "Expects filename as a string"
        self.metadata["fname"] = fname
        self.metadata["used_ke"] = ke

    # ------------------------------------------------------------------
    # state plumbing
    # ------------------------------------------------------------------

    def clear(self):
        """Clear all data, leave metadata (gc_hist.pyx:123-129)."""
        self.data = {}

    def reload(self):
        """(re)Load from the netCDF4 file (gc_hist.pyx:131-182)."""
        try:
            raw = _io.read_composite(self.metadata["fname"], op_name=self._NC_OP_NAME)
        except Exception as e:
            raise Exception("Unable to load data from %s : %s" % (self.metadata["fname"], e))
        self._take(raw)

    def _take(self, raw):
        """Reset the state to the reference conditions and take the
        composite ``raw`` (the read_composite dict) into self.data, with
        the reference's load-time checks."""
        self.clear()
        self.data["curr_mu"] = copy.copy(self.metadata["mu_ref"])
        self.data["curr_beta"] = copy.copy(self.metadata["beta_ref"])
        self.data["nspec"] = copy.copy(self.metadata["nspec"])

        assert raw["nspec"] == self.metadata["nspec"], (
            "Different number of species in datafile from information initially specified"
        )
        self.metadata["file_history"] = raw["history"]
        self.data["ln(PI)"] = raw["lnpi"]
        self.data["max_order"] = raw["max_order"]
        assert self.data["max_order"] > 0, "Error, max_order < 1"
        self.data["volume"] = raw["volume"]
        assert self.data["volume"] > 0, "Error, volume <= 0"
        self.data[self._OP_KEY] = raw["op"]
        self.data["lb"] = self.data[self._OP_KEY][0]
        self.data["ub"] = self.data[self._OP_KEY][-1]
        assert self.data["lb"] < self.data["ub"], "Error, bad bounds for N_tot"
        self.data["pk_hist"] = raw.get("pk_hist", {})
        self.data["e_hist"] = raw.get("e_hist", {})
        self.data["mom"] = raw["mom"]
        S, M1 = self.data["nspec"], self.data["max_order"] + 1
        assert self.data["mom"].shape == (S, M1, S, M1, M1, len(self.data[self._OP_KEY]))

    # device-state bridges -------------------------------------------------

    def _meta(self, max_phases=8):
        return HistMeta(
            nspec=int(self.data["nspec"]),
            max_order=int(self.data["max_order"]),
            used_ke=bool(self.metadata["used_ke"]),
            smooth=int(self.metadata["smooth"]),
            max_phases=max_phases,
        )

    def _hist(self) -> Hist:
        lnpi = np.asarray(self.data["ln(PI)"], dtype=np.float64)
        n = len(lnpi)
        return make_hist(
            lnpi=lnpi,
            mom=np.asarray(self.data["mom"], dtype=np.float64)[..., :n],
            op=np.asarray(self.data[self._OP_KEY], dtype=np.float64)[:n],
            curr_mu=self.data["curr_mu"],
            curr_beta=self.data["curr_beta"],
            volume=self.data["volume"],
            device=self.device,
        )

    def _absorb(self, h: Hist, mom: bool = True):
        """Write a device state back into self.data."""
        self.data["ln(PI)"] = _np(h.lnpi)
        if mom:
            self.data["mom"] = _np(h.mom)
        self.data["curr_mu"] = _np(h.curr_mu)
        self.data["curr_beta"] = float(h.curr_beta)

    # ------------------------------------------------------------------
    # basic operations
    # ------------------------------------------------------------------

    def normalize(self):
        """Normalize ln(PI) (gc_hist.pyx:260-266)."""
        h = self._hist()
        self.data["ln(PI)"] = _np(_ops.normalize(h).lnpi)

    def reweight(self, mu1_target, print_screen=False):
        """Reweight to a new mu_1 and renormalize (gc_hist.pyx:268-289)."""
        h = _ops.reweight(self._hist(), float(mu1_target))
        self._absorb(h, mom=False)
        if print_screen:
            lnpi = self.data["ln(PI)"]
            for i in range(len(lnpi)):
                print(i, lnpi[i] - lnpi[0])

    def mix(self, other, weights):
        """Distance-weighted blend of two histograms at identical
        (beta, mu, V); different upper bounds allowed, the longer histogram
        wins beyond the overlap (gc_hist.pyx:184-258)."""
        tol = 1.0e-9
        if self.metadata["nspec"] != other.metadata["nspec"]:
            raise Exception("Difference in conditions, cannot mix histograms")
        if self.metadata["used_ke"] != other.metadata["used_ke"]:
            raise Exception("Difference in conditions, cannot mix histograms")
        if self.data["nspec"] != other.data["nspec"]:
            raise Exception("Difference in conditions, cannot mix histograms")
        if abs(self.data["curr_beta"] - other.data["curr_beta"]) > tol:
            raise Exception("Difference in conditions, cannot mix histograms")
        if not np.all(np.abs(np.asarray(self.data["curr_mu"]) - np.asarray(other.data["curr_mu"])) < tol):
            raise Exception("Difference in conditions, cannot mix histograms")
        if abs(self.data["volume"] - other.data["volume"]) > tol:
            raise Exception("Difference in conditions, cannot mix histograms")
        if self.data["max_order"] != other.data["max_order"]:
            raise Exception("Difference in conditions, cannot mix histograms")
        if len(self.data["mom"]) != len(other.data["mom"]):
            raise Exception("Difference in conditions, cannot mix histograms")
        if self.data["lb"] != other.data["lb"]:
            raise Exception("Difference in conditions, cannot mix histograms")
        if not isinstance(weights, (np.ndarray, list, tuple)):
            raise Exception("Requires 2 weights, cannot mix histograms")
        if len(weights) != 2:
            raise Exception("Requires 2 weights, cannot mix histograms")

        if len(self.data["ln(PI)"]) >= len(other.data["ln(PI)"]):
            longer_one = self
            max_idx = len(other.data["ln(PI)"])
        else:
            longer_one = other
            max_idx = len(self.data["ln(PI)"])

        mixed = copy.deepcopy(longer_one)
        mixed.data["file_history"] = "this is a mixed histogram"
        mixed.metadata["fname"] = ""
        mixed.metadata["beta_ref"] = mixed.data["curr_beta"]
        mixed.metadata["mu_ref"] = mixed.data["curr_mu"]

        w0, w1 = weights[0], weights[1]
        mixed.data["ln(PI)"] = np.asarray(mixed.data["ln(PI)"], dtype=np.float64)
        mixed.data["ln(PI)"][:max_idx] = (
            np.asarray(self.data["ln(PI)"][:max_idx]) * w0 + w1 * np.asarray(other.data["ln(PI)"][:max_idx])
        ) / (w0 + w1)
        mixed.data["mom"] = np.asarray(mixed.data["mom"], dtype=np.float64)
        mixed.data["mom"][..., :max_idx] = (
            np.asarray(self.data["mom"][..., :max_idx]) * w0 + w1 * np.asarray(other.data["mom"][..., :max_idx])
        ) / (w0 + w1)

        mixed.data["pk_hist"] = {}
        mixed.data["e_hist"] = {}
        return mixed

    # ------------------------------------------------------------------
    # segmentation & thermo
    # ------------------------------------------------------------------

    def relextrema(self):
        """Find local extrema of ln(PI); writes ln(PI)_maxima_idx /
        ln(PI)_minima_idx (gc_hist.pyx:317-415)."""
        lnpi = np.asarray(self.data["ln(PI)"], dtype=np.float64)
        if len(lnpi) - 1 <= 1:
            raise Exception("ln(PI) not long enough to analyze for relative extrema")
        if self.metadata["smooth"] < 1:
            raise Exception("smooth must be >= 1 to find relative extrema")
        P = self._max_phases(lnpi)
        ext = _segment.relextrema(torch.as_tensor(lnpi, device=self.device)[None], self.metadata["smooth"], P)
        n_max, n_min = int(ext.n_max[0]), int(ext.n_min[0])
        if not bool(ext.valid[0]):
            if n_max > P or n_min > P + 1:
                raise Exception(
                    "Surface has %d maxima / %d minima, exceeding the %d phase slots "
                    "(the padded device representation caps at 64; raise smooth to merge "
                    "noise extrema)" % (n_max, n_min, P)
                )
            raise Exception(
                "There are %d local maxima and %d local minima, so cannot be alternating, "
                "try adjusting the value of smooth" % (n_max, n_min)
            )
        self.data["ln(PI)_maxima_idx"] = _np(ext.maxima[0])[:n_max].astype(np.int64)
        self.data["ln(PI)_minima_idx"] = _np(ext.minima[0])[:n_min].astype(np.int64)

    def _max_phases(self, lnpi):
        """Static phase-slot budget for the fixed-shape device segmentation.

        N//2+2 covers EVERY possible alternating structure for surfaces up
        to 124 bins; longer surfaces are capped at 64 slots (a surface with
        more than 64 alternating extrema is measurement noise — raise
        `smooth`).  Exceeding the cap raises with an explicit message (see
        relextrema) rather than silently truncating.  The batched device
        pipelines take their budget from `_meta(max_phases=8)` instead —
        under-sizing there reads as `valid=False` in the output masks.
        """
        return max(8, min(len(lnpi) // 2 + 2, 64))

    def coexisting(self, rtol=1.0e-3):
        """Indices of phases with equal free energy (gc_hist.pyx:417-449)."""
        if "thermo" not in self.data:
            raise Exception("Thermodynamic properties should be called first (self.thermo())")
        if len(self.data["thermo"]) == 1:
            return [[]]
        eq = []
        for i in range(len(self.data["thermo"])):
            x = [i]
            for j in range(i + 1, len(self.data["thermo"])):
                fi = self.data["thermo"][i]["F.E./kT"]
                fj = self.data["thermo"][j]["F.E./kT"]
                if abs((fi - fj) / fi) < rtol:
                    x.append(j)
            if len(x) > 1:
                eq.append(x)
        return eq

    def thermo(self, props=True, complete=False, collect=None):
        """Integrate lnPI per phase; fill data['thermo'] (gc_hist.pyx:451-554).

        The collect hook mutates the extrema index lists between
        segmentation and integration, so integration bounds are derived
        host-side from the (possibly collected) index arrays; the heavy
        averaging math runs vectorized.
        """
        try:
            self.normalize()
        except Exception as e:
            raise Exception("Unable to normalize ln(PI) : %s" % e)

        if not complete:
            try:
                self.relextrema()
            except Exception as e:
                raise Exception("Unable to find relative extrema : %s" % e)
            if collect is not None:
                collect(hist=self)
            nphases = len(self.data["ln(PI)_maxima_idx"])
        else:
            nphases = 1

        lnpi = np.asarray(self.data["ln(PI)"], dtype=np.float64)
        n = len(lnpi)
        maxima = np.asarray(self.data.get("ln(PI)_maxima_idx", []), dtype=np.int64)
        minima = np.asarray(self.data.get("ln(PI)_minima_idx", []), dtype=np.int64)

        phase = {}
        min_ctr = 0
        for p in range(nphases):
            phase[p] = {}
            if not complete:
                if maxima[p] > 0:
                    left = int(minima[min_ctr])
                    min_ctr += 1
                else:
                    left = 0
                if maxima[p] < n - 1:
                    right = int(minima[min_ctr])
                else:
                    right = n
                if right == n - 1:
                    right += 1
            else:
                left, right = 0, n

            rel = lnpi[left:right] - lnpi[0]
            m = np.max(rel)
            phase[p]["F.E./kT"] = -(m + np.log(np.sum(np.exp(rel - m))))
            phase[p]["bound_idx"] = (left, right)

            if props:
                # per-phase max shift: the mom/prob ratio is invariant
                # under prob -> prob*exp(-m), and a deep subdominant
                # phase (every lnpi < ~-745) would otherwise underflow
                # sum_prob to 0 and emit a 0/0 RuntimeWarning
                prob = np.exp(lnpi[left:right] - np.max(lnpi[left:right]))
                sum_prob = np.sum(prob)
                mom = np.asarray(self.data["mom"], dtype=np.float64)
                # one fused tensordot over the phase slice (reference's
                # 5-nested loop, gc_hist.pyx:534-541)
                phase[p]["mom"] = np.tensordot(mom[..., left:right], prob, axes=([-1], [0])) / sum_prob

                nsum = 0.0
                for i in range(self.data["nspec"]):
                    phase[p]["n%d" % (i + 1)] = phase[p]["mom"][i, 1, 0, 0, 0]
                    nsum += phase[p]["mom"][i, 1, 0, 0, 0]
                phase[p]["ntot"] = nsum
                phase[p]["density"] = nsum / self.data["volume"]
                phase[p]["u"] = phase[p]["mom"][0, 0, 0, 0, 1]
                for i in range(self.data["nspec"]):
                    phase[p]["x%d" % (i + 1)] = phase[p]["mom"][i, 1, 0, 0, 0] / nsum

        self.data["thermo"] = phase

    def is_safe(self, cutoff=10.0, complete=False):
        """Edge-effect guard on the lnPI tail (gc_hist.pyx:556-596)."""
        lnpi = np.asarray(self.data["ln(PI)"], dtype=np.float64)
        if not complete:
            if "ln(PI)_maxima_idx" not in self.data:
                try:
                    self.normalize()
                except Exception as e:
                    raise Exception("Unable to normalize ln(PI) : %s" % e)
                try:
                    self.relextrema()
                except Exception as e:
                    raise Exception("Unable to find relative extrema in ln(PI) : %s" % e)
                lnpi = np.asarray(self.data["ln(PI)"], dtype=np.float64)
            maxima = lnpi[self.data["ln(PI)_maxima_idx"]]
            return not (maxima[-1] - lnpi[-1] < cutoff)
        else:
            return not (np.max(lnpi) - lnpi[-1] < cutoff)

    # ------------------------------------------------------------------
    # smoothing stubs (parity with gc_hist.pyx:291-315)
    # ------------------------------------------------------------------

    def _lowess_smooth(self, x, y, frac):
        """Lowess (tricube-weighted local linear) smoothing.

        The reference wraps statsmodels lowess (gc_hist.pyx:291-307, unused
        in the main pipeline); this is a self-contained equivalent
        returning the same (x, fitted) column layout.
        """
        assert 0 < frac < 1, "Bad fraction to smooth over"
        x = np.asarray(x, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64)
        order = np.argsort(x)
        xs, ys = x[order], y[order]
        n = len(xs)
        r = max(2, int(np.ceil(frac * n)))
        fitted = np.empty(n)
        for i in range(n):
            d = np.abs(xs - xs[i])
            cut = np.sort(d)[r - 1]
            w = np.clip(1.0 - (d / max(cut, 1e-300)) ** 3, 0.0, 1.0) ** 3
            sw = np.sum(w)
            xm = np.sum(w * xs) / sw
            ym = np.sum(w * ys) / sw
            cov = np.sum(w * (xs - xm) * (ys - ym))
            var = np.sum(w * (xs - xm) ** 2)
            b = cov / var if var > 1e-300 else 0.0
            fitted[i] = ym + b * (xs[i] - xm)
        return np.column_stack([xs, fitted])

    def _butter_smooth(self):
        """Butterworth placeholder (reference returns None, gc_hist.pyx:309-315)."""
        return

    # ------------------------------------------------------------------
    # phase equilibrium
    # ------------------------------------------------------------------

    def find_phase_eq(
        self,
        lnZ_tol,
        mu_guess,
        beta=0.0,
        dMu=[],
        extrap_order=1,
        cutoff=10.0,
        override=False,
        reterr=False,
        first_order_mom=False,
        collect=None,
    ):
        """Search for two-phase coexistence in mu_1 (gc_hist.pyx:598-668).

        Uses scipy Nelder-Mead over a device-evaluated objective for exact
        reference behavior; the fully on-device vmappable solver lives in
        core.solve.find_phase_eq_state.
        """
        tmp_hist = copy.deepcopy(self)
        curr_dMu = np.array(
            [self.data["curr_mu"][i] - self.data["curr_mu"][0] for i in range(1, self.data["nspec"])],
            dtype=np.float64,
        )
        if len(dMu) == 0:
            new_dMu = copy.copy(curr_dMu)
        else:
            assert len(dMu) == self.data["nspec"] - 1, "Need to specify dMu for components 2-N"
            new_dMu = np.array(dMu, dtype=np.float64)
        if beta <= 0.0:
            beta = self.data["curr_beta"]

        tmp_hist.normalize()
        min_width = tmp_hist.metadata["smooth"] * 2

        full_out = scipy.optimize.fmin(
            phase_eq_error,
            mu_guess,
            ftol=lnZ_tol,
            args=(tmp_hist, beta, new_dMu, extrap_order, cutoff, True, min_width, collect),
            maxfun=100000,
            maxiter=100000,
            full_output=True,
            disp=False,
            retall=True,
        )
        if full_out[4] != 0:
            raise Exception("Error, unable to locate phase coexistence : %s" % str(full_out))

        try:
            tmp_hist.reweight(full_out[0][0])
            if beta != self.data["curr_beta"] or np.all(new_dMu == curr_dMu) == False:  # noqa: E712
                tmp_hist.temp_dmu_extrap(beta, new_dMu, extrap_order, cutoff, override, False, False, first_order_mom)
            tmp_hist.thermo(collect=collect)
        except Exception as e:
            raise Exception("Found coexistence, but unable to compute properties afterwards: %s" % e)

        if reterr:
            return tmp_hist, full_out[1]
        return tmp_hist

    # ------------------------------------------------------------------
    # extrapolation drivers
    # ------------------------------------------------------------------

    def _edge_check(self, cutoff, override):
        if override:
            return
        lnpi = np.asarray(self.data["ln(PI)"], dtype=np.float64)
        assert np.max(lnpi) - cutoff > lnpi[-1], (
            "Error, histogram edge effect encountered in temperature extrapolation"
        )

    def _check_not_extrapolated_beta(self):
        if np.abs(self.metadata["beta_ref"] - self.data["curr_beta"]) > 1.0e-6:
            raise Exception("Cannot extrapolate the same histogram class twice")

    def _check_not_extrapolated_dmu(self):
        orig_dmu = self.metadata["mu_ref"][1:] - self.metadata["mu_ref"][0]
        curr_dmu = np.asarray(self.data["curr_mu"])[1:] - np.asarray(self.data["curr_mu"])[0]
        if np.any(np.abs(orig_dmu - curr_dmu) > 1.0e-6):
            raise Exception("Cannot extrapolate the same histogram class twice")

    def _check_needed_order(self, order, skip_mom):
        needed = order if skip_mom else order + 1
        if self.data["max_order"] < needed:
            raise Exception("Maximum order stored in simulation not high enough to calculate this order of extrapolation")

    def temp_extrap(self, target_beta, order=1, cutoff=10.0, override=False, clone=True, skip_mom=False):
        """Temperature extrapolation, orders 1-3 (gc_hist.pyx:670-740)."""
        self._check_not_extrapolated_beta()
        self._check_needed_order(order, skip_mom)
        if order not in (1, 2, 3):
            raise Exception("No implementation for temperature extrapolation of order %s" % order)
        tmp_hist = copy.deepcopy(self) if clone else self
        tmp_hist.normalize()
        tmp_hist._edge_check(cutoff, override)
        try:
            h = _extrap.temp_extrap(tmp_hist._hist(), tmp_hist._meta(), float(target_beta), order, skip_mom)
        except Exception as e:
            raise Exception("Unable to extrapolate in temperature: %s" % e)
        tmp_hist._absorb(h)
        return tmp_hist

    def dmu_extrap(self, target_dmu, order=1, cutoff=10.0, override=False, clone=True, skip_mom=False):
        """dMu extrapolation, orders 1-2 (gc_hist.pyx:742-811)."""
        target_dmu = np.asarray(target_dmu, dtype=np.float64)
        assert len(target_dmu) == self.data["nspec"] - 1, "Must specify delta mu for all components 2-N"
        self._check_not_extrapolated_dmu()
        self._check_needed_order(order, skip_mom)
        if order not in (1, 2):
            raise Exception("No implementation for dMu extrapolation of order %s" % order)
        tmp_hist = copy.deepcopy(self) if clone else self
        tmp_hist.normalize()
        tmp_hist._edge_check(cutoff, override)
        try:
            h = _extrap.dmu_extrap(tmp_hist._hist(), tmp_hist._meta(), target_dmu, order, skip_mom)
        except Exception as e:
            raise Exception("Unable to extrapolate in dMu: %s" % e)
        tmp_hist._absorb(h)
        return tmp_hist

    def temp_dmu_extrap(
        self,
        target_beta,
        target_dmu,
        order=1,
        cutoff=10.0,
        override=False,
        clone=True,
        skip_mom=False,
        first_order_mom=False,
    ):
        """Joint (beta, dMu) extrapolation, orders 1-2 (gc_hist.pyx:889-966)."""
        target_dmu = np.asarray(target_dmu, dtype=np.float64)
        self._check_not_extrapolated_beta()
        assert len(target_dmu) == self.data["nspec"] - 1, "Must specify delta mu for all components 2-N"
        self._check_not_extrapolated_dmu()
        self._check_needed_order(order, skip_mom)
        if order not in (1, 2):
            raise Exception("No implementation for temperature + dMu extrapolation of order %s" % order)
        tmp_hist = copy.deepcopy(self) if clone else self
        tmp_hist.normalize()
        tmp_hist._edge_check(cutoff, override)
        try:
            h = _extrap.temp_dmu_extrap(
                tmp_hist._hist(), tmp_hist._meta(), float(target_beta), target_dmu, order, skip_mom, first_order_mom
            )
        except Exception as e:
            raise Exception("Unable to extrapolate : %s" % e)
        tmp_hist._absorb(h)
        return tmp_hist

    def temp_dmu_extrap_multi(
        self,
        target_betas,
        target_dmus,
        order=1,
        cutoff=10.0,
        override=False,
        skip_mom=False,
        first_order_mom=False,
    ):
        """Grid extrapolation over all (beta, dMu) pairs (gc_hist.pyx:813-887).

        One batched device launch (core.extrap.temp_dmu_extrap_grid)
        instead of the reference's clone-per-target loop; returns the same
        2-D nested list of histogram objects.
        """
        target_betas = np.atleast_1d(np.asarray(target_betas, dtype=np.float64))
        target_dmus = np.atleast_2d(np.asarray(target_dmus, dtype=np.float64))
        self._check_not_extrapolated_beta()
        for target_dmu in target_dmus:
            assert len(target_dmu) == self.data["nspec"] - 1, "Must specify delta mu for all components 2-N"
        self._check_not_extrapolated_dmu()
        self._check_needed_order(order, skip_mom)
        if order not in (1, 2):
            raise Exception("No implementation for temperature + dMu extrapolation of order %s" % order)
        self._edge_check(cutoff, override)

        try:
            hb = _extrap.temp_dmu_extrap_grid(
                self._hist(), self._meta(), target_betas, target_dmus, order, skip_mom, first_order_mom
            )
        except Exception as e:
            raise Exception("Unable to extrapolate : %s" % e)

        lnpi = _np(hb.lnpi)
        mom = _np(hb.mom)
        hists = []
        for a in range(len(target_betas)):
            row = []
            for b in range(len(target_dmus)):
                clone = copy.deepcopy(self)
                clone.data["ln(PI)"] = lnpi[a, b]
                clone.data["mom"] = mom[a, b]
                clone.data["curr_beta"] = float(target_betas[a])
                clone.data["curr_mu"] = np.concatenate(
                    [[self.data["curr_mu"][0]], self.data["curr_mu"][0] + target_dmus[b]]
                )
                row.append(clone)
            hists.append(row)
        return hists

    # ------------------------------------------------------------------
    # derivative kernels exposed for parity testing (gc_hist.pyx:1241-2563)
    # ------------------------------------------------------------------

    def _engine(self):
        return DerivEngine(self._hist(), self._meta())

    def _vec(self, a):
        """A host vector as a f64 tensor on the histogram's device."""
        return torch.as_tensor(np.asarray(a, dtype=np.float64), device=self.device)

    def _gc_ave_v(self, a):
        return float(self._engine().gc_ave_v(self._vec(a)))

    def _gc_ave_i(self, x_idx):
        return float(self._engine().gc_ave_i(tuple(x_idx)))

    def _gc_fluct_vv(self, a, b):
        return float(self._engine().gc_fluct_vv(self._vec(a), self._vec(b)))

    def _gc_fluct_vi(self, a, y_idx):
        return float(self._engine().gc_fluct_vi(self._vec(a), tuple(y_idx)))

    def _gc_fluct_iv(self, y_idx, a):
        return self._gc_fluct_vi(a, y_idx)

    def _gc_fluct_ii(self, x_idx, y_idx):
        return float(self._engine().gc_fluct_ii(tuple(x_idx), tuple(y_idx)))

    def _gc_dX_dB(self, x_idx, n=0):
        return float(self._engine().gc_dX_dB(tuple(x_idx), n))

    def _gc_d2X_dB2(self, x_idx, n=0):
        return float(self._engine().gc_d2X_dB2(tuple(x_idx), n))

    def _gc_df_dB_ii(self, x_idx_t, y_idx_t):
        (x, nx), (y, ny) = x_idx_t, y_idx_t
        return float(self._engine().gc_df_dB_ii((tuple(x), nx), (tuple(y), ny)))

    def _gc_df_dB_in(self, x_idx_t, n=0):
        x, nx = x_idx_t
        return float(self._engine().gc_df_dB_in((tuple(x), nx), n))

    def _sg_dX_dB(self, x_idx, n=0):
        return _np(self._engine().sg_dX_dB(tuple(x_idx), n))

    def _sg_dX_dMU(self, q, x_idx):
        return _np(self._engine().sg_dX_dMU(q, tuple(x_idx)))

    def _sg_d2X_dB2(self, x_idx, n=0):
        return _np(self._engine().sg_d2X_dB2(tuple(x_idx), n))

    def _sg_d2X_dMU2(self, q, r, x_idx):
        return _np(self._engine().sg_d2X_dMU2(q, r, tuple(x_idx)))

    def _sg_d3X_dB3(self, x_idx, n=0):
        return _np(self._engine().sg_d3X_dB3(tuple(x_idx), n))

    def _sg_df_dB(self, x_idx_t, y_idx_t):
        (x, nx), (y, ny) = x_idx_t, y_idx_t
        return _np(self._engine().sg_df_dB((tuple(x), nx), (tuple(y), ny)))

    def _sg_df_dMU(self, j, x_idx, y_idx):
        return _np(self._engine().sg_df_dMU(j, tuple(x_idx), tuple(y_idx)))

    def _sg_d2f_dB2(self, x_idx_t, y_idx_t):
        (x, nx), (y, ny) = x_idx_t, y_idx_t
        return _np(self._engine().sg_d2f_dB2((tuple(x), nx), (tuple(y), ny)))

    def _order_mom_address(self, idx):
        return np.array(order_mom_address(tuple(idx)), dtype=np.int64)

    def _mom_prod(self, x_idx, y_idx):
        return np.array(
            mom_prod(tuple(x_idx), tuple(y_idx), self.data["nspec"], self.data["max_order"]), dtype=np.int64
        )

    def _dB(self, skip_mom=False):
        d, m = self._engine().dB(skip_mom)
        return _np(d), _np(m)

    def _dB2(self, skip_mom=False):
        d, m = self._engine().dB2(skip_mom)
        return _np(d), _np(m)

    def _dB3(self, skip_mom=False):
        d, m = self._engine().dB3(skip_mom)
        return _np(d), _np(m)

    def _dMU(self, skip_mom=False):
        d, m = self._engine().dMU(skip_mom)
        return _np(d), _np(m)

    def _dMU2(self, skip_mom=False):
        d, m = self._engine().dMU2(skip_mom)
        return _np(d), _np(m)

    def _dBMU(self, skip_mom=False):
        d, m = self._engine().dBMU(skip_mom)
        return _np(d), _np(m)

    def _dBMU2(self, skip_mom=False):
        d, m = self._engine().dBMU2(skip_mom)
        return _np(d), _np(m)


def _min_pair_fe_error(thermo_dict, min_width):
    """Width-filtered min-over-pairs squared F.E./kT gap
    (gc_hist.pyx:2614-2628; shared by the ntot and n1 engines)."""
    default = 100.0
    num_phases = len(thermo_dict)
    if num_phases == 1:
        return default
    errs = []
    for i in range(num_phases):
        bi = thermo_dict[i]["bound_idx"]
        if bi[1] - bi[0] >= min_width:
            for j in range(i + 1, num_phases):
                bj = thermo_dict[j]["bound_idx"]
                if bj[1] - bj[0] >= min_width:
                    errs.append((thermo_dict[i]["F.E./kT"] - thermo_dict[j]["F.E./kT"]) ** 2)
    if not errs:
        return default
    return min(errs)


def phase_eq_error(mu_guess, orig_hist, beta, dMu, order, cutoff, override, min_width, collect):
    """Squared F.E./kT difference between closest phase pair at mu_guess.

    Module-level objective for scipy fmin, mirroring gc_hist.pyx:2570-2630.
    """
    if np.ndim(mu_guess) > 0:
        mu_guess = float(np.asarray(mu_guess).reshape(-1)[0])
    hist = copy.deepcopy(orig_hist)
    hist.reweight(mu_guess)
    curr_dMu = np.array(
        [hist.data["curr_mu"][i] - hist.data["curr_mu"][0] for i in range(1, hist.data["nspec"])]
    )
    if beta != orig_hist.data["curr_beta"] or np.all(curr_dMu == dMu) == False:  # noqa: E712
        hist.temp_dmu_extrap(beta, dMu, order, cutoff, override, False, True)
    hist.thermo(props=False, collect=collect)
    return _min_pair_fe_error(hist.data["thermo"], min_width)
