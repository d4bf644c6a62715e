"""F(h) free-energy providers for slit pores.

Parity: the reference's moments/histogram/two_dim/h_ntot/
free_energy_profile.pyx.

The PyTorch port's copy of the JAX package's
``two_dim/free_energy_profile.py`` (host-only).
"""

from __future__ import annotations

import numpy as np
import scipy.interpolate
from numpy.polynomial.polynomial import polyval

__all__ = ["interp", "polynomial"]


class interp(object):
    """Linear interpolation of (h, F(h)) from a two-column file; clamps to
    max F outside the data range (free_energy_profile.pyx:24-69)."""

    def __init__(self, filename):
        self.filename = filename
        try:
            raw = np.loadtxt(self.filename, comments="#")
            self.h = np.array([i[0] for i in raw])
            self.f = np.array([i[1] for i in raw])
        except Exception as e:
            raise Exception("Unable to read profile from %s : %s" % (self.filename, e))
        self.interpolate = scipy.interpolate.interp1d(
            self.h, self.f, bounds_error=False, fill_value=np.max(self.f)
        )

    def free_energy(self, h):
        return self.interpolate(h)

    __call__ = free_energy


class polynomial(object):
    """Polynomial F(h), coefficients given from leading order
    (free_energy_profile.pyx:71-107)."""

    def __init__(self, C):
        self.coeffs = np.asarray(C)[::-1]
        self.order = len(self.coeffs) - 1

    def free_energy(self, h):
        return polyval(h, self.coeffs)

    __call__ = free_energy
