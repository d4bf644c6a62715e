"""Synthetic N_tot composites for the PyTorch port's tests and chip_smoke.py.

numpy only: the machine with the GPU has neither JAX nor h5py, and the
reference's .nc fixtures are not in the repository.  Each composite is the
``to_host`` dict both packages load (``fhmcanalysis_tpu.core.state.make_hist``
and ``fhmcanalysis_torch.core.state.from_host``):

* lnPI(N) is a smooth two-basin surface (a vapor and a liquid peak with a
  barrier between) spanning hundreds of log units;
* op = arange(N): the order parameter is N_tot;
* the moments tensor N_i^j N_k^m U^p is self-consistent: per-bin N_i and U
  profiles with inflated higher powers, as tests/test_gc_n1.py's
  make_n1_fixture builds them, for nspec 1 or 2 and max_order 2 (3 for
  the extrapolating sweep).

``CELLS`` holds the three sweep cells (sizes of the JAX bench's workloads)
with a mu_1 window that crosses coexistence: one-phase points at the low
end, two-phase points at the high end, every point valid.  ``iso_sources``
and ``ISO31`` / ``ISO1400`` build the isopleth sources and grids from the
same composites, ``COEX573`` / ``coex_grid`` and ``COEX31`` /
``coex31_guesses`` the coexistence solves, and
``port_histogram`` the port's histogram class from a dict without a file.
"""

from __future__ import annotations

import numpy as np

MAX_ORDER = 2

# name -> composite + sweep parameters.  B is the main-path batch of the
# cell; tests and parity phases run a few points of the same window.
CELLS = {
    # the JAX bench headline's shape: reweight_thermo_points_per_sec
    "n31": dict(N=31, nspec=2, smooth=1, max_phases=4, B=2_097_152, beta=1.0, mu0=(5.0, 0.0), seed=31),
    # reweight_thermo_N573_points_per_sec: the square-well T=0.90 composite
    "n573": dict(N=573, nspec=1, smooth=10, max_phases=4, B=524_288, beta=1.0 / 0.90, mu0=(0.0,), seed=573),
    # coverage: the old NPAD-2048 ceiling of the TPU kernel
    "n1400": dict(N=1400, nspec=2, smooth=2, max_phases=4, B=4096, beta=1.0, mu0=(5.0, 0.0), seed=1400),
}

# tilt of the reweighted surface across the window, in log units per unit
# of N/(N-1): the low end removes the liquid peak (one phase), the high end
# keeps both peaks (two phases)
_SLOPE_LO, _SLOPE_HI = -1850.0, 350.0


def _infl(a, b, p):
    return 1.0 + 0.02 * (a * (a - 1) + b * (b - 1) + p * (p - 1)) + 0.001 * (a * b + b * p)


def make_composite(N: int, nspec: int, beta: float, mu0, seed: int, max_order: int = MAX_ORDER, **_) -> dict:
    """A two-phase N_tot composite as a ``to_host`` dict of numpy arrays."""
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
    for i in range(nspec):
        for j in range(mo1):
            for k in range(nspec):
                for m in range(mo1):
                    for p in range(mo1):
                        a = (j if i == 0 else 0) + (m if k == 0 else 0)
                        b = (j if i == 1 else 0) + (m if k == 1 else 0)
                        mom[i, j, k, m, p] = n1**a * n2**b * u**p * _infl(a, b, p)
    return {
        "lnpi": lnpi,
        "mom": mom,
        "op": n,
        "curr_mu": np.asarray(mu0, dtype=np.float64),
        "curr_beta": float(beta),
        "volume": float(N) * 1.25,
    }


def mu_window(N: int, beta: float, mu0, **_) -> tuple[float, float]:
    """The mu_1 range of a cell's sweep (one phase -> two phases)."""
    return mu0[0] + _SLOPE_LO / (N - 1) / beta, mu0[0] + _SLOPE_HI / (N - 1) / beta


def cell(name: str, points: int | None = None, max_order: int = MAX_ORDER, used_ke: bool = False):
    """(composite dict, meta kwargs, mu grid) of a named cell; ``points``
    overrides the cell's batch size.  The (beta, dMu) extrapolating sweep
    needs max_order 3 for its order-2 moment rows; moments up to power 2
    are the same at any max_order."""
    c = CELLS[name]
    lo, hi = mu_window(**c)
    mus = np.linspace(lo, hi, c["B"] if points is None else points)
    meta = dict(nspec=c["nspec"], max_order=max_order, used_ke=used_ke, smooth=c["smooth"], max_phases=c["max_phases"])
    return make_composite(**dict(c, max_order=max_order)), meta, mus


# The (mu_1, beta, dMu) extrapolating sweep's main-path grid: the JAX
# bench's mu_beta_extrap_o{1,2}_points_per_sec shape (bench.py:913-916),
# M mu_1 values over the cell's window times A (beta, dMu) targets paired
# row by row, on the n31 composite at max_order 3.
MB31 = dict(cell="n31", max_order=3, M=65_536, A=64, beta=(0.92, 1.08), dmu=(-5.5, -4.5))


def mb_grid(M: int | None = None, A: int | None = None, **over):
    """(composite dict, meta kwargs, mus [M], betas [A], dmus [A, 1]) of
    the mb31 grid; M and A default to the main path's."""
    g = dict(MB31, **over)
    M = g["M"] if M is None else M
    A = g["A"] if A is None else A
    d, meta, mus = cell(g["cell"], M, max_order=g["max_order"], used_ke=g.get("used_ke", False))
    betas = np.linspace(*g["beta"], A)
    dmus = np.linspace(*g["dmu"], A)[:, None]
    return d, meta, mus, betas, dmus


# The coexistence cell: trace_coexistence on the n573 composite built at
# max_order 3, in the JAX bench's coexistence shape (bench.py:797-815):
# 256 betas evenly spaced, lnZ_tol 1e-6, min_width = 2 * smooth, order 1,
# one mu guess for every beta.  The bench's span, T in [0.88, 0.92], and
# its guess (-4.03) belong to the real square-well fixture.  On this
# composite the objective is flat (DEFAULT_ERR2) wherever |dF.E./kT| > 10,
# which leaves each beta a basin ~0.05 wide in mu around a coexistence mu
# that moves by 0.115 over that span (0.082 at T = 0.92 to -0.033 at 0.88),
# so no one guess reaches every beta there.  The span is narrowed to T in
# [0.895, 0.905], where mu* runs from 0.0384 to 0.0098 and the guess 0.022
# lies inside every basin: JAX's trace_coexistence converges at all 256
# betas from it on the CPU, to (dF.E./kT)^2 <= 1.6e-16
# (tests/coex573_span.py prints the search).
COEX573 = dict(cell="n573", max_order=3, B=256, T=(0.895, 0.905), guess=0.022, lnZ_tol=1e-6, order=1)


def coex_grid(B: int | None = None, **over):
    """(composite dict, meta kwargs, betas [B], mu guess, trace kwargs) of
    the coexistence cell; B defaults to its 256 betas."""
    g = dict(COEX573, **over)
    d, meta, _ = cell(g["cell"], 1, max_order=g["max_order"])
    betas = np.linspace(1.0 / g["T"][1], 1.0 / g["T"][0], g["B"] if B is None else B)
    kw = dict(lnZ_tol=g["lnZ_tol"], order=g["order"], min_width=2 * meta["smooth"])
    return d, meta, betas, g["guess"], kw


# The coexistence solve without extrapolation (kernel K1's objective): a
# batch of mu guesses on the n31 composite, whose coexistence mu (5.556)
# has a basin over [5.1, 6.1]; min_width = 2 * smooth.
COEX31 = dict(cell="n31", max_order=3, B=256, guesses=(5.2, 6.0), lnZ_tol=1e-6)


def coex31_guesses(B: int | None = None):
    """(composite dict, meta kwargs, mu guesses [B], solve kwargs) of the
    K1 coexistence solve; B defaults to 256 guesses."""
    g = COEX31
    d, meta, _ = cell(g["cell"], 1, max_order=g["max_order"])
    return d, meta, np.linspace(*g["guesses"], g["B"] if B is None else B), dict(lnZ_tol=g["lnZ_tol"], min_width=2 * meta["smooth"])


def composite_raw(d: dict, nspec: int, max_order: int, history: str = "synthetic composite") -> dict:
    """A ``to_host`` dict as the ``read_composite`` dict of a file holding
    it (op stored as int64, as the file schema stores it)."""
    return {
        "history": history,
        "volume": float(d["volume"]),
        "nspec": int(nspec),
        "max_order": int(max_order),
        "lnpi": np.array(d["lnpi"], dtype=np.float64),
        "op": np.asarray(d["op"]).astype(np.int64),
        "mom": np.array(d["mom"], dtype=np.float64),
    }


def port_histogram(d: dict, meta: dict, device=None, history: str = "synthetic composite"):
    """The port's N_tot ``histogram`` built from a ``to_host`` dict without
    a file (the machine with the card has no h5py), through the class's
    own load path (``histogram.from_composite`` -> ``_take``); reference
    conditions are the dict's curr_beta / curr_mu."""
    from fhmcanalysis_torch.histogram.ntot import histogram

    raw = composite_raw(d, meta["nspec"], meta["max_order"], history)
    return histogram.from_composite(raw, d["curr_beta"], d["curr_mu"], smooth=meta["smooth"], ke=meta["used_ke"], device=device)


# The isopleth sources: one composite at several reference dMu_2 (mu_2 -
# mu_1), each with a small deterministic tilt of lnPI (TILT * j * N/(N-1)
# for source j) so that the inverse-distance mix of two sources is not the
# same surface twice.  dMu_2 -5 and -4 bracket the main-path rows.
ISO_DMU2 = (-5.0, -4.0)
TILT = 0.5


def iso_sources(name: str = "n31", dmu2s=ISO_DMU2, max_order: int = 3, used_ke: bool = False, lnpi=None, smooth=None):
    """([to_host dict per source], meta kwargs) of the isopleth sources
    built from a named cell's composite; ``lnpi`` replaces the composite's
    surface (before the tilt), ``smooth`` the cell's."""
    d, meta, _ = cell(name, 1, max_order=max_order, used_ke=used_ke)
    if smooth is not None:
        meta = dict(meta, smooth=smooth)
    N = len(d["lnpi"])
    t = np.arange(N, dtype=np.float64) / (N - 1)
    base = d["lnpi"] if lnpi is None else np.asarray(lnpi, dtype=np.float64)
    mu1 = d["curr_mu"][0]
    out = [dict(d, lnpi=base + TILT * j * t, curr_mu=np.array([mu1, mu1 + dm])) for j, dm in enumerate(dmu2s)]
    return out, meta


# The isopleth main-path grid: the JAX bench's isopleth grid shape
# (bench.py:942-975), 301 dMu_2 rows x 834 mu_1 columns = 251,034 cells on
# the n31 sources above, beta_target 1.02, m = 2.5.  The mu_1 window is
# the n31 sweep cell's (one phase at the low end, two at the high end).
# ISO1400 is the secondary timing at N=1400: 128 x 128 cells, beta_target
# = beta_ref (at 1400 bins any real beta step tilts the tail by hundreds of
# log units and every cell turns edge-unsafe).
ISO31 = dict(name="n31", NX=834, NY=301, dmu2=(-4.95, -4.05), beta=1.02)
ISO1400 = dict(name="n1400", NX=128, NY=128, dmu2=(-4.95, -4.05), beta=1.0)
# K3's shape coverage at one cell per lane (256 cells a block): a narrow
# grid over five sources, whose 12 mu_1 columns make a block span ~22
# dMu_2 rows and name up to four sources; and a grid of 7 x 256 + 13
# cells, whose last block is partial.  The rows reach past the sources on
# both sides (clamped rows).
ISO_FIVE_DMU2 = (-5.0, -4.6, -4.2, -3.8, -3.4)
ISO_NARROW = dict(name="n31", NX=12, NY=40, dmu2=(-5.3, -3.1), beta=1.02)
ISO_PARTIAL = dict(name="n31", NX=95, NY=19, dmu2=(-5.3, -3.7), beta=1.02)


def iso_grid_args(g: dict, NX: int | None = None, NY: int | None = None):
    """(mu1_bounds, dmu2_bounds, delta) for isopleth.make_grid giving
    exactly NY x NX cells (each delta widened by 1e-9 relative so that
    make_grid's ceil cannot add a row or column)."""
    NX = g["NX"] if NX is None else NX
    NY = g["NY"] if NY is None else NY
    c = CELLS[g["name"]]
    mu1 = mu_window(**c)
    d0 = (mu1[1] - mu1[0]) / (NX - 1) * (1 + 1e-9)
    d1 = (g["dmu2"][1] - g["dmu2"][0]) / (NY - 1) * (1 + 1e-9)
    return mu1, g["dmu2"], (d0, d1)


# The randomized lnPI structures of tests/test_pallas_sweep.py
# (test_randomized_structures_parity), which bias toward endpoint
# minima/maxima and near-edge peaks, the places segmentation went wrong.
SURFACE_KINDS = ("edge_peaks", "min_at_end", "multi_well", "rough", "plateaus")


def random_surface(kind: str, n: int, rng: np.random.Generator) -> np.ndarray:
    x = np.linspace(0.0, 1.0, n)
    if kind == "edge_peaks":  # peaks crowding the right edge (bin N-1 shared)
        return 8 * np.exp(-((x - 0.8) ** 2) / 0.003) + 10 * np.exp(-((x - 0.97) ** 2) / 0.001) + rng.normal(size=n) * 0.1
    if kind == "min_at_end":  # minimum exactly at N-1
        return 9 * np.exp(-((x - 0.5) ** 2) / 0.01) - 5 * x + rng.normal(size=n) * 0.05
    if kind == "multi_well":
        k = int(rng.integers(2, 5))
        return sum(a * np.exp(-((x - c) ** 2) / w) for c, w, a in zip(rng.random(k), 0.002 + 0.01 * rng.random(k), 4 + 12 * rng.random(k)))
    if kind == "rough":
        return rng.normal(size=n) * 3
    if kind == "plateaus":  # exact integer ties
        return rng.integers(-3, 4, size=n).astype(float)
    raise ValueError(kind)


def janus_surfaces(n: int) -> list:
    """Multi-peak surfaces for the janus collect (3 and 4 peaks, big-last
    and big-first, and a 2-peak no-op), from test_pallas_sweep.py."""
    x = np.linspace(0.0, 1.0, n)
    g = lambda c, w, a: a * np.exp(-((x - c) ** 2) / w)  # noqa: E731
    return [
        g(0.15, 0.004, 5) + g(0.45, 0.003, 4) + g(0.8, 0.006, 12),
        g(0.1, 0.002, 6) + g(0.35, 0.002, 5) + g(0.6, 0.002, 7) + g(0.85, 0.003, 14),
        g(0.2, 0.006, 15) + g(0.55, 0.002, 4) + g(0.85, 0.003, 5),
        g(0.3, 0.005, 8) + g(0.75, 0.005, 9),
    ]


# The shuffled mu grid: mu_1 over a window wide enough that the n31
# composite passes through none / max-only / both-found with one, two and
# three phases, and its negation (lnpi -> -lnpi) through none / min-only /
# both-found.  Every 32 consecutive points -- one warp when a lane holds a
# point -- take one value from each of 32 equal slices of the window, in a
# seeded random order, so no warp sees one segmentation case only.
SHUFFLE_WINDOW = (-150.0, 150.0)


def shuffled_mu_grid(points: int, seed: int = 0, window=SHUFFLE_WINDOW) -> np.ndarray:
    """``points`` mu_1 values, stratified over ``window`` per group of 32
    (the last group may be partial) and shuffled within each group."""
    rng = np.random.default_rng(seed)
    lo, hi = window
    out = np.empty(points)
    for start in range(0, points, 32):
        n = min(32, points - start)
        out[start : start + n] = rng.permutation(lo + (hi - lo) * (np.arange(n) + rng.random(n)) / n)
    return out


def worst_abs_diff(got, want, ok) -> float:
    """max |got - want| over the slots where ``ok`` (broadcast over trailing
    axes); each side is masked before subtracting, and equal values (fe is
    +inf on an empty masked phase on both sides) differ by 0."""
    got, want, ok = np.asarray(got), np.asarray(want), np.asarray(ok)
    ok = ok.reshape(ok.shape + (1,) * (got.ndim - ok.ndim))
    g, w = np.where(ok, got, 0.0), np.where(ok, want, 0.0)
    with np.errstate(invalid="ignore"):
        d = np.where(g == w, 0.0, np.abs(g - w))
    return float(d.max()) if d.size else 0.0
