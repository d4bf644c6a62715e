"""Collect segmented lnPI peaks into "macrophases".

Parity: the reference's moments/histogram/one_dim/ntot/collect.py; the
PyTorch port's copy of the JAX package's ``histogram/collect.py`` (numpy).
"""

from __future__ import annotations

import numpy as np

__all__ = ["check_order_", "janus_collect"]


def check_order_(hist):
    """Check that maxima/minima indices alternate correctly
    (collect.py:10-30)."""
    maxima = np.asarray(hist.data["ln(PI)_maxima_idx"])
    minima = np.asarray(hist.data["ln(PI)_minima_idx"])
    order = np.zeros(len(maxima) + len(minima))
    if maxima[0] < minima[0]:
        order[::2] = maxima
        order[1::2] = minima
    else:
        order[::2] = minima
        order[1::2] = maxima
    if not np.all(order[:-1] <= order[1:]):
        raise Exception("Local maxima and minima not sorted correctly after collection")


def janus_collect(hist, **kwargs):
    """Collect the last peak as an isotropic-liquid phase and merge all
    earlier peaks into one micellar-gas phase (collect.py:32-80).

    Note: the reference leaves max_idx/min_idx unbound when there are
    <= 2 peaks and then assigns them (a latent NameError); here the
    histogram is left unchanged in that case, per the documented intent.
    """
    if "ln(PI)_maxima_idx" not in hist.data:
        raise Exception("Histogram has not been segmented yet")
    if "ln(PI)_minima_idx" not in hist.data:
        raise Exception("Histogram has not been segmented yet")

    check_order_(hist)

    maxima = np.asarray(hist.data["ln(PI)_maxima_idx"])
    minima = np.asarray(hist.data["ln(PI)_minima_idx"])
    if len(maxima) <= 2:
        return

    max_idx = [int(round(np.mean(maxima[:-1]))), int(maxima[-1])]
    if minima[0] > 0:
        min_idx = []
    else:
        min_idx = [0]

    last = int(minima[-1])
    if max_idx[0] < last < max_idx[1]:
        min_idx.append(last)
    elif last > max_idx[1]:
        assert len(minima) > 1
        min_idx.append(int(minima[-2]))
        min_idx.append(int(minima[-1]))

    check_order_(hist)
    hist.data["ln(PI)_maxima_idx"] = np.asarray(max_idx, dtype=np.int64)
    hist.data["ln(PI)_minima_idx"] = np.asarray(min_idx, dtype=np.int64)
