"""The benchmark's frozen copy of the seeded composite generators.

numpy only, and independent of the program and of the test suite: the
yardstick's inputs may not move when either does.  A composite is a
``to_host``-schema dict (lnpi, mom, op, curr_mu, curr_beta, volume):

* lnPI(N) is a smooth two-basin surface (a vapor and a liquid peak with a
  barrier between) over ~325 log units; it does not depend on the seed,
  so every seed segments into the same phases;
* op = arange(N): the order parameter is N_tot;
* the moments N_i^j N_k^m U^p are self-consistent per-bin N_i and U
  profiles with inflated higher powers; three numbers drawn from the seed
  perturb the mole fraction and energy profiles by a few percent.
"""

from __future__ import annotations

import numpy as np

# tilt of the reweighted surface across a sweep window, in log units per
# unit of N/(N-1): the low end leaves one phase, the high end two
SLOPE_LO, SLOPE_HI = -1850.0, 350.0


def _infl(a, b, p):
    return 1.0 + 0.02 * (a * (a - 1) + b * (b - 1) + p * (p - 1)) + 0.001 * (a * b + b * p)


def make_composite(N: int, nspec: int, beta: float, mu0, seed: int, max_order: int, volume: float) -> dict:
    """A two-phase N_tot composite of one or two species."""
    if nspec not in (1, 2):
        raise ValueError(f"the composites hold one or two species, got {nspec}")
    rng = np.random.default_rng(seed)
    n = np.arange(N, dtype=np.float64)
    t = n / (N - 1)
    lnpi = 300.0 * np.exp(-(((t - 0.1) / 0.08) ** 2)) + 320.0 * np.exp(-(((t - 0.7) / 0.18) ** 2)) - 50.0 * t

    c = rng.uniform(-0.05, 0.05, size=3)
    x1 = 0.3 + 0.4 * t + c[0] * np.sin(6.0 * t) if nspec == 2 else np.ones(N)
    n1 = x1 * n
    n2 = n - n1
    u = -n * (0.5 + (2.5 + c[1]) * t + c[2] * t**2)

    mo1 = max_order + 1
    mom = np.zeros((nspec, mo1, nspec, mo1, mo1, N))
    for i, j, k, m, p in np.ndindex(nspec, mo1, nspec, mo1, mo1):
        a = (j if i == 0 else 0) + (m if k == 0 else 0)
        b = (j if i == 1 else 0) + (m if k == 1 else 0)
        mom[i, j, k, m, p] = n1**a * n2**b * u**p * _infl(a, b, p)
    return {
        "lnpi": lnpi,
        "mom": mom,
        "op": n,
        "curr_mu": np.asarray(mu0, dtype=np.float64),
        "curr_beta": float(beta),
        "volume": float(volume),
    }


def config_composite(cfg: dict, seed: int) -> dict:
    """The composite of a configuration file's sizes, drawn from seed."""
    return make_composite(cfg["N"], cfg["nspec"], cfg["beta"], cfg["mu0"], seed, cfg["max_order"], cfg["volume"])


def mu_window(N: int, beta: float, mu0) -> tuple[float, float]:
    """The mu_1 range over which the surface goes from one phase to two."""
    return mu0[0] + SLOPE_LO / (N - 1) / beta, mu0[0] + SLOPE_HI / (N - 1) / beta


def jittered(lo: float, hi: float, rng: np.random.Generator, share: float) -> tuple[float, float]:
    """[lo, hi] with each end moved by up to share of its width, drawn
    from rng."""
    w = hi - lo
    d = rng.uniform(-share, share, size=2) * w
    return lo + float(d[0]), hi + float(d[1])
