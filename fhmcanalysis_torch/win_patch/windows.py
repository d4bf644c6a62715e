"""Window-bound generators for flat-histogram simulations.

Parity: the reference's moments/win_patch/windows.py.

The PyTorch port's copy of the JAX package's ``win_patch/windows.py``, line
for line.
"""

from __future__ import annotations

import numpy as np

__all__ = ["n1_window_scaling", "ntot_window_scaling"]


def n1_window_scaling(n_f, w_max, n_ov):
    """Equal-width windows with fixed overlap for an N_1 order parameter.

    Parity: windows.py:10-40.  Returns list of (lb, ub) tuples; note the
    reference appends one extra trailing window up to n_f.
    """
    dw = int(round((n_f + (w_max - 1) * n_ov) / float(w_max)))
    assert n_ov < dw / 2.0, (
        "overlap n_ov >= half the window width: windows beyond nearest "
        "neighbors would share bins; reduce w_max or n_ov"
    )
    bounds = [(0, dw)]
    for i in range(1, w_max):
        lb = bounds[i - 1][1] - n_ov
        ub = lb + dw
        bounds.append((lb, ub))
    bounds.append((bounds[-1][1] - n_ov, n_f))
    return bounds


def ntot_window_scaling(n_f, dw, w_max, n_ov):
    """Power-law window widths, ub = round(c * x^alpha), for N_tot.

    Parity: windows.py:42-76.  Returns list of (lb, ub) tuples.
    """
    dw -= n_ov  # account for overlap
    assert n_ov < w_max, "overlap n_ov must be smaller than the window count w_max"

    alpha = np.log(float(n_f) / (float(n_f) - float(dw))) / np.log(w_max / (w_max - 1.0))
    coeff = float(n_f) / (float(w_max) ** alpha)

    x = np.linspace(1, w_max, int(w_max))
    ub = np.round(coeff * x**alpha).astype(int)
    lb = [0]
    for i in range(1, int(w_max)):
        lb.append(int(ub[i - 1]) - n_ov + 1)

    return list(zip(lb, [int(u) for u in ub]))
