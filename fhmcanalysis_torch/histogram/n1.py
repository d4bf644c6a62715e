"""Grand-canonical 1-D histogram with N_1 as the order parameter.

Drop-in replacement for the reference's n1 engine
(moments/histogram/one_dim/n1/gc_hist.pyx): a thin configuration of the
N_tot machinery with

  - reweighting by N_1, updating only mu_1 (n1/gc_hist.pyx:70-78, 259-282)
  - extrapolation in (beta, absolute mu_2..mu_S) via ``temp_mu_extrap``
    (:566-1043) instead of (beta, dMu)
  - mandatory pk/e sub-histograms and an N_1-vs-moments consistency check
    on load (:160-172)
  - no kinetic-energy support, no 3rd-order beta, no collect hook

per SURVEY §7.7: one engine, two order-parameter configurations.  The
PyTorch port's copy of the JAX package's ``histogram/n1.py``.
"""

from __future__ import annotations

import copy

import numpy as np
import scipy.optimize

from ..core import extrap as _extrap
from ..core import ops as _ops
from ..core.derivs import DerivEngineN1
from ..core.state import HistMeta
from . import ntot as _ntot

__all__ = ["histogram", "phase_eq_error"]


class histogram(_ntot.histogram):
    """N_1 order-parameter histogram (reference n1/gc_hist.pyx:80-1733)."""

    _OP_KEY = "n1"
    _NC_OP_NAME = "N_{1}"
    _ENGINE_CLS = DerivEngineN1

    def __init__(self, fname, beta_ref, mu_ref, smooth=0, ke=False, device=None):
        # the n1 reference does not support KE contributions; the flag is
        # accepted for signature parity but ignored (n1/gc_hist.pyx:84)
        super().__init__(fname, beta_ref, mu_ref, smooth, False, device)

    @classmethod
    def from_composite(cls, raw, beta_ref, mu_ref, smooth=0, ke=False, device=None):
        return super().from_composite(raw, beta_ref, mu_ref, smooth, False, device)

    def _take(self, raw):
        """Take a composite; pk_hist and e_hist are REQUIRED and the N_1
        column must match mom[0,1,0,0,0] (n1/gc_hist.pyx:133-174)."""
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
        self.data["n1"] = raw["op"]
        self.data["lb"] = self.data["n1"][0]
        self.data["ub"] = self.data["n1"][-1]
        assert self.data["lb"] < self.data["ub"], "Error, bad bounds for N_1"
        if "pk_hist" not in raw or "e_hist" not in raw:
            raise Exception("N_1 composite requires particle-number and energy sub-histograms")
        self.data["pk_hist"] = raw["pk_hist"]
        self.data["e_hist"] = raw["e_hist"]
        self.data["mom"] = raw["mom"]
        S, M1 = self.data["nspec"], self.data["max_order"] + 1
        assert self.data["mom"].shape == (S, M1, S, M1, M1, len(self.data["n1"]))
        assert np.all((self.data["mom"][0, 1, 0, 0, 0] - self.data["n1"]) < 1.0e-9), (
            "N_{1} order parameter inconsistent with moments"
        )

    def _meta(self, max_phases=8):
        return HistMeta(
            nspec=int(self.data["nspec"]),
            max_order=int(self.data["max_order"]),
            used_ke=False,
            smooth=int(self.metadata["smooth"]),
            max_phases=max_phases,
        )

    def reweight(self, mu1_target, print_screen=False):
        """Reweight by N_1; only curr_mu[0] changes (n1/gc_hist.pyx:259-282)."""
        h = _ops.reweight(self._hist(), float(mu1_target), rigid_mu=False)
        self._absorb(h, mom=False)
        if print_screen:
            lnpi = self.data["ln(PI)"]
            for i in range(len(lnpi)):
                print(i, lnpi[i] - lnpi[0])

    def _engine(self):
        return DerivEngineN1(self._hist(), self._meta())

    def thermo(self, props=True, complete=False, collect=None):
        """Same integration as ntot; the n1 reference has no collect hook
        (n1/gc_hist.pyx:438-528)."""
        if collect is not None:
            raise Exception("The N_1 engine does not support a collect hook")
        return super().thermo(props=props, complete=complete, collect=None)

    # ------------------------------------------------------------------
    # extrapolation — absolute-mu targets
    # ------------------------------------------------------------------

    def _check_not_extrapolated_mu(self):
        orig_mu = self.metadata["mu_ref"][1:]
        curr_mu = np.asarray(self.data["curr_mu"])[1:]
        if np.any(np.abs(orig_mu - curr_mu) > 1.0e-6):
            raise Exception("Cannot extrapolate the same histogram class twice")

    def temp_mu_extrap(self, target_beta, target_mus, order=1, cutoff=10.0, override=False, clone=True, skip_mom=False):
        """Joint (beta, absolute mu_2..mu_S) extrapolation, orders 1-2
        (n1/gc_hist.pyx:566-640)."""
        target_mus = np.asarray(target_mus, dtype=np.float64)
        self._check_not_extrapolated_beta()
        assert len(target_mus) == self.data["nspec"] - 1, "Must specify mu values for all components 2-N"
        self._check_not_extrapolated_mu()
        self._check_needed_order(order, skip_mom)
        if order not in (1, 2):
            raise Exception("No implementation for temperature + mu extrapolation of order %s" % order)
        tmp_hist = copy.deepcopy(self) if clone else self
        tmp_hist.normalize()
        tmp_hist._edge_check(cutoff, override)
        try:
            h = _extrap.temp_mu_extrap(tmp_hist._hist(), tmp_hist._meta(), float(target_beta), target_mus, order, skip_mom)
        except Exception as e:
            raise Exception("Unable to extrapolate : %s" % e)
        tmp_hist._absorb(h)
        return tmp_hist

    def temp_mu_extrap_multi(self, target_betas, target_mus, order=1, cutoff=10.0, override=False, skip_mom=False):
        """Grid extrapolation over all (beta, mu) pairs in one batched
        launch (n1/gc_hist.pyx:1497-1733)."""
        target_betas = np.atleast_1d(np.asarray(target_betas, dtype=np.float64))
        target_mus = np.atleast_2d(np.asarray(target_mus, dtype=np.float64))
        self._check_not_extrapolated_beta()
        for target_mu in target_mus:
            assert len(target_mu) == self.data["nspec"] - 1, "Must specify mu for all components 2-N"
        self._check_not_extrapolated_mu()
        self._check_needed_order(order, skip_mom)
        if order not in (1, 2):
            raise Exception("No implementation for temperature + mu extrapolation of order %s" % order)
        self._edge_check(cutoff, override)

        try:
            hb = _extrap.temp_mu_extrap_grid(self._hist(), self._meta(), target_betas, target_mus, order, skip_mom)
        except Exception as e:
            raise Exception("Unable to extrapolate : %s" % e)

        lnpi = np.asarray(hb.lnpi)
        mom = np.asarray(hb.mom)
        hists = []
        for a in range(len(target_betas)):
            row = []
            for b in range(len(target_mus)):
                clone = copy.deepcopy(self)
                clone.data["ln(PI)"] = lnpi[a, b]
                clone.data["mom"] = mom[a, b]
                clone.data["curr_beta"] = float(target_betas[a])
                clone.data["curr_mu"] = np.concatenate([[self.data["curr_mu"][0]], target_mus[b]])
                row.append(clone)
            hists.append(row)
        return hists

    # the dMu-based ntot drivers do not exist on the n1 engine
    def dmu_extrap(self, *a, **kw):
        raise AttributeError("N_1 engine extrapolates in absolute mu; use temp_mu_extrap")

    def temp_dmu_extrap(self, *a, **kw):
        raise AttributeError("N_1 engine extrapolates in absolute mu; use temp_mu_extrap")

    def temp_dmu_extrap_multi(self, *a, **kw):
        raise AttributeError("N_1 engine extrapolates in absolute mu; use temp_mu_extrap_multi")

    def temp_extrap(self, target_beta, order=1, cutoff=10.0, override=False, clone=True, skip_mom=False):
        """Temperature-only extrapolation via the N_1 kernels (orders 1-2)."""
        if order not in (1, 2):
            raise Exception("No implementation for temperature extrapolation of order %s" % order)
        self._check_not_extrapolated_beta()
        self._check_needed_order(order, skip_mom)
        tmp_hist = copy.deepcopy(self) if clone else self
        tmp_hist.normalize()
        tmp_hist._edge_check(cutoff, override)
        try:
            h = _extrap.temp_extrap(
                tmp_hist._hist(), tmp_hist._meta(), float(target_beta), order, skip_mom, engine_cls=DerivEngineN1
            )
        except Exception as e:
            raise Exception("Unable to extrapolate in temperature: %s" % e)
        tmp_hist._absorb(h)
        return tmp_hist

    def find_phase_eq(
        self,
        lnZ_tol,
        mu_guess,
        beta=0.0,
        mus=[],
        extrap_order=1,
        cutoff=10.0,
        override=False,
    ):
        """Two-phase coexistence in mu_1 with min_width = smooth
        (n1/gc_hist.pyx:1435-1496)."""
        tmp_hist = copy.deepcopy(self)
        curr_mu = np.array(self.data["curr_mu"][1:], dtype=np.float64)
        if len(mus) == 0:
            new_mu = copy.copy(curr_mu)
        else:
            assert len(mus) == self.data["nspec"] - 1, "Need to specify mu for components 2-N"
            new_mu = np.array(mus, dtype=np.float64)
        if beta <= 0.0:
            beta = self.data["curr_beta"]

        tmp_hist.normalize()
        full_out = scipy.optimize.fmin(
            phase_eq_error,
            mu_guess,
            ftol=lnZ_tol,
            args=(tmp_hist, beta, new_mu, extrap_order, cutoff, True, tmp_hist.metadata["smooth"]),
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
            if beta != self.data["curr_beta"] or np.all(new_mu == curr_mu) == False:  # noqa: E712
                tmp_hist.temp_mu_extrap(beta, new_mu, extrap_order, cutoff, override, False)
            tmp_hist.thermo()
        except Exception as e:
            raise Exception("Found coexistence, but unable to compute properties afterwards: %s" % e)

        return tmp_hist


def phase_eq_error(mu_guess, orig_hist, beta, mus, order, cutoff, override, min_width):
    """Min-pair squared F.E./kT gap at mu_guess for the N_1 engine.

    Parity: n1/gc_hist.pyx:1739-1832 (min_width = smooth); shares the
    pair scan with the ntot engine.
    """
    if np.ndim(mu_guess) > 0:
        mu_guess = float(np.asarray(mu_guess).reshape(-1)[0])
    hist = copy.deepcopy(orig_hist)
    hist.reweight(mu_guess)
    curr_mu = np.array(hist.data["curr_mu"][1:])
    if beta != orig_hist.data["curr_beta"] or np.all(curr_mu == mus) == False:  # noqa: E712
        hist.temp_mu_extrap(beta, mus, order, cutoff, override, False, True)
    hist.thermo(props=False)
    return _ntot._min_pair_fe_error(hist.data["thermo"], min_width)
