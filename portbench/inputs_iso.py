"""The benchmark's frozen copy of the binary ideal gas in closed form.

numpy only, and independent of the program and of the test suite: the
yardstick's inputs may not move when either does.  Per reference
difference dMu_2 = mu_2 - mu_1 one grand-canonical composite at
mu_ref = (0, dMu_2) and beta_ref, N_tot 0..N-1 in a box of volume V:

    lnPI(N) = N ln(V (z_1 + z_2)) - ln N!,   z_1 = exp(beta mu_1) = 1,
    z_2 = kappa exp(beta dMu_2),

the moments <N_1^a N_2^b> the binomial moments of N_1 given N_tot with
p = z_1 / (z_1 + z_2), N_2 = N_tot - N_1, and U = 0.  kappa = (Lambda_1 /
Lambda_2)^3 is the species weight; the seed draws it from KAPPA, and the
gas stays exact for every kappa.  A composite is a ``read_composite``
dict (lnpi, op, mom, volume, nspec, max_order, history).
"""

from __future__ import annotations

import math

import numpy as np

KAPPA = (1.005, 1.015)  # the range the seed draws kappa from


def kappa(seed: int) -> float:
    """The species weight of a seed."""
    return float(np.random.default_rng(seed).uniform(*KAPPA))


def composite(N: int, V: float, beta: float, dmu2: float, kappa_: float, max_order: int) -> dict:
    """The gas at (beta, dMu_2) over N_tot 0..N-1."""
    z1, z2 = 1.0, kappa_ * math.exp(beta * dmu2)
    p = z1 / (z1 + z2)
    lg = np.array([math.lgamma(n + 1.0) for n in range(N)])  # ln n!
    n = np.arange(N, dtype=np.float64)
    lnpi = n * math.log(V * (z1 + z2)) - lg
    top = 2 * max_order  # the highest joint power a moment product reaches
    pw = np.zeros((top + 1, top + 1, N))  # <N_1^a N_2^b> at each N_tot
    for t in range(N):
        k = np.arange(t + 1, dtype=np.float64)
        pmf = np.exp(lg[t] - lg[: t + 1] - lg[t::-1] + k * math.log(p) + (t - k) * math.log1p(-p))
        for a in range(top + 1):
            for b in range(top + 1 - a):
                pw[a, b, t] = np.sum(pmf * k**a * (t - k) ** b)
    pw[0, 0] = 1.0
    mo1 = max_order + 1
    mom = np.zeros((2, mo1, 2, mo1, mo1, N))
    for i, j, k_, m in np.ndindex(2, mo1, 2, mo1):
        a = (j if i == 0 else 0) + (m if k_ == 0 else 0)  # the power of N_1; U^p = 0 for p > 0
        mom[i, j, k_, m, 0] = pw[a, j + m - a]
    return {"history": "binary ideal gas, beta = %r, dMu2 = %r, kappa = %r" % (beta, dmu2, kappa_), "volume": float(V), "nspec": 2,
            "max_order": int(max_order), "lnpi": lnpi, "op": np.arange(N, dtype=np.int64), "mom": mom}


def sources(cfg: dict, seed: int) -> dict:
    """{dMu_2: composite} of a configuration's simulations, kappa drawn
    from seed."""
    k = kappa(seed)
    return {float(d): composite(cfg["N"], cfg["volume"], cfg["beta"], float(d), k, cfg["max_order"]) for d in cfg["dmu2"]}
