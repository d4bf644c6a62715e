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
  make_n1_fixture builds them, for nspec 1-4 and max_order 2 (3 for the
  extrapolating sweep).

``CELLS`` holds the three sweep cells (sizes of the JAX bench's workloads)
with a mu_1 window that crosses coexistence: one-phase points at the low
end, two-phase points at the high end, every point valid.  ``iso_sources``
and ``ISO31`` / ``ISO1400`` build the isopleth sources and grids from the
same composites, ``COEX573`` / ``coex_grid`` and ``COEX31`` /
``coex31_guesses`` the coexistence solves, and
``port_histogram`` the port's histogram class from a dict without a file.
``CAPACITY`` and ``capacity_cell`` build the inputs beyond the kernels'
first build (more than 8 phase slots, 3-4 species): rippled surfaces
with 9-30 maxima, the fail-code test's ten-peak isopleth sources, and
three- and four-species composites.
The 2-D path's surfaces are joint_hist entries (``joint`` enters them into
either package's class): ``CELLS2D`` holds the pore13, pore96 and joint96
cells built from copies of the JAX bench's builders and states, beside
the JAX tests' two-basin, tie and random surfaces, and
``joint_class_oracle`` runs the class numpy engine on one joint GC state.
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
    if nspec <= 2:
        for i, j, k, m, p in np.ndindex(nspec, mo1, nspec, mo1, mo1):
            a = (j if i == 0 else 0) + (m if k == 0 else 0)
            b = (j if i == 1 else 0) + (m if k == 1 else 0)
            mom[i, j, k, m, p] = n1**a * n2**b * u**p * _infl(a, b, p)
    else:
        # mole fractions of smooth positive weights, one wave per species
        w = np.stack([1.0 + 0.5 * np.sin((s + 1) * 3.0 * t + s + c[0]) for s in range(nspec)])
        ns = w / w.sum(0) * n
        for i, j, k, m, p in np.ndindex(nspec, mo1, nspec, mo1, mo1):
            e = np.zeros(nspec, dtype=int)
            e[i] += j
            e[k] += m
            mom[i, j, k, m, p] = np.prod([ns[s] ** e[s] for s in range(nspec)], axis=0) * u**p * _infl(e[0], e[1], p)
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


# The row former's grid (cuda_mb.mb_rows held to pipeline._mb_rows bit for
# bit): every (order, props, first_order_mom) the extrapolating sweep
# admits, first_order_mom only where it changes the rows (order 2 with
# props), each over used_ke and ROW_MAX_ORDERS.
ROW_CASES = [(o, p, f) for o in (1, 2) for p in (True, False) for f in (False, True) if not f or (o == 2 and p)]
ROW_MAX_ORDERS = (1, 2, 3, 4)


def row_inputs(name: str, max_order: int, used_ke: bool):
    """((composite, random), meta kwargs) of the row former's checks on a
    cell: its composite dict, and the same with every moment, beta and mu
    drawn from normals, where no two addresses hold the same row, so a
    wrong address cannot agree by chance."""
    d, mk, _ = cell(name, 8, max_order=max_order, used_ke=used_ke)
    rng = np.random.default_rng((CELLS[name]["N"], max_order, int(used_ke)))
    rand = dict(d, mom=rng.normal(size=d["mom"].shape), curr_beta=float(rng.uniform(0.5, 2.0)), curr_mu=rng.normal(size=mk["nspec"]) * 3.0)
    return (d, rand), mk


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


# Inputs beyond the kernels' first build (max_phases <= 8, nspec <= 2).
# The JAX package's kernels take any max_phases (its class path caps the
# padded device representation at 64) and K1 any nspec, so the port's
# wide builds (launch.CAPACITIES) are held to these:
#   ten31: the fail-code test's ten-peak surface (``ten_peak``, ~10
#     maxima) on the n31 composite's moments, smooth 1;
#   ripple121: lnPI = 6 sin(2 pi n / 9) - 0.02 n on the moments of a
#     121-bin two-species composite, smooth 1: 15 maxima over the window,
#     so every point overflows 8 slots and fits 16 (the CPU tests' surface);
#   multi573: the n573 surface at nspec 2 (dMu_ref -5, as mb31) plus a
#     ripple 8 sin(2 pi n / 19), smooth 1: 11-25 maxima over n573's mu
#     window, so 8 slots overflow everywhere, 16 hold about a quarter of
#     the points and 32 all of them;
#   tern573, quat573: the n573 cell at three and four species (K1's
#     6-sum build), max_phases 4 as n573.
# overflow31 (``ten_peak``) is the surface of the JAX package's fail-code
# test (tests/test_fail_codes.py, ~10 maxima: fail code 3 at 8 slots) for
# the isopleth sources; overflow1400 (``ripple1400``) the iso1400 sources'
# surface with a ripple, on ISO1400's grid (K3's wide build at N = 1400).
CAPACITY = {
    "ten31": dict(N=31, nspec=2, smooth=1, max_phases=16, B=32, beta=1.0, mu0=(5.0, 0.0), seed=31, window=(4.8, 5.2)),
    "ripple121": dict(N=121, nspec=2, smooth=1, max_phases=16, B=48, beta=1.0, mu0=(5.0, 0.0), seed=121, window=(4.0, 6.0)),
    "multi573": dict(N=573, nspec=2, smooth=1, max_phases=64, B=524_288, beta=1.0 / 0.90, mu0=(0.0, -5.0), seed=573, ripple=(8.0, 19.0)),
    "tern573": dict(N=573, nspec=3, smooth=10, max_phases=4, B=524_288, beta=1.0 / 0.90, mu0=(0.0, -5.0, -5.0), seed=573),
    "quat573": dict(N=573, nspec=4, smooth=10, max_phases=4, B=524_288, beta=1.0 / 0.90, mu0=(0.0, -5.0, -5.0, -5.0), seed=573),
}


def ten_peak(n: int = 31) -> np.ndarray:
    """The JAX fail-code test's overflow surface: 5 sin(2 pi x / 3.1) -
    0.01 x, its last bin 50 below its minimum (keeps the edge guard out of
    the way)."""
    x = np.arange(n, dtype=np.float64)
    y = 5.0 * np.sin(2 * np.pi * x / 3.1) - 0.01 * x
    y[-1] = y.min() - 50.0
    return y


def ripple1400(seed: int = 1400) -> np.ndarray:
    """overflow1400's surface: the n1400 composite's lnPI plus a ripple
    8 sin(2 pi n / 50 + phi), phi drawn from ``seed``, its last bin 50
    below its minimum (as ``ten_peak``: keeps the edge guard out of the
    way).  Over ISO1400's window at smooth 2 each cell's mixed surface has
    10-20 maxima: fail code 3 on every cell at 8 slots, some cells ok at
    16, nearly all at 64."""
    c = CELLS["n1400"]
    n = np.arange(c["N"], dtype=np.float64)
    phase = np.random.default_rng(seed).uniform(0.0, 2 * np.pi)
    y = make_composite(**c)["lnpi"] + 8.0 * np.sin(2 * np.pi * n / 50.0 + phase)
    y[-1] = y.min() - 50.0
    return y


def capacity_cell(name: str, points: int | None = None, max_order: int = MAX_ORDER, max_phases: int | None = None):
    """(composite dict, meta kwargs, mu grid) of a ``CAPACITY`` cell;
    ``points`` and ``max_phases`` override the cell's."""
    c = CAPACITY[name]
    d = make_composite(**dict(c, max_order=max_order))
    n = np.arange(c["N"], dtype=np.float64)
    if name == "ten31":
        d["lnpi"] = ten_peak(c["N"])
    elif name == "ripple121":
        d["lnpi"] = 6.0 * np.sin(2 * np.pi * n / 9.0) - 0.02 * n
    elif "ripple" in c:
        amp, period = c["ripple"]
        d["lnpi"] = d["lnpi"] + amp * np.sin(2 * np.pi * n / period)
    lo, hi = c.get("window") or mu_window(**c)
    mus = np.linspace(lo, hi, c["B"] if points is None else points)
    meta = dict(nspec=c["nspec"], max_order=max_order, used_ke=False, smooth=c["smooth"], max_phases=c["max_phases"] if max_phases is None else max_phases)
    return d, meta, mus


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


# ---------------------------------------------------------------------------
# 2-D surfaces: joint histograms lnPI(h, N_tot) and lnPI(N_1, N_tot)
# ---------------------------------------------------------------------------
#
# Copies of the JAX bench's builders (bench.py:110-210) and of the JAX
# tests' (test_pore_pipeline.py _two_hill_joint, test_joint_pipeline.py
# _two_basin_joint, test_device_watershed.py _rand_surface), as lists of
# joint_hist entries (op_1, lnPI slice, op_2 values, properties) that
# ``joint`` enters into either package's joint_hist class.


def joint(entries, cls=None):
    """A joint_hist of ``entries`` (default class: the port's)."""
    if cls is None:
        from fhmcanalysis_torch.two_dim import joint_hist as cls
    jh = cls()
    for op1, lnpi, ops, props in entries:
        jh.enter(op1, lnpi, ops, props)
    return jh


def pore13_entries():
    """bench.py _pore_joint, identical to the tests' _two_hill_joint: H=13
    pore widths, ragged N rows, two Gaussian hills whose relative
    stability flips with the applied pressure p."""
    H, N = 13, 21
    g1_0 = np.exp(-25.0 / 12.0)
    g2_0 = np.exp(-225.0 / 12.0)
    out = []
    for i in range(H):
        nmax = min(12 + (i // 2) * 2, N - 1)
        n = np.arange(0, nmax + 1, dtype=float)
        G1 = np.exp(-((n - 5.0) ** 2) / 12.0) - g1_0
        G2 = np.exp(-((n - 15.0) ** 2) / 12.0) - g2_0
        lnpi = 40.0 * np.exp(-((i - 3.0) ** 2) / 8.0) * G1 + 55.0 * np.exp(-((i - 9.0) ** 2) / 8.0) * G2
        out.append((float(i + 1), lnpi, n.astype(int), {"N_tot": n, "U": -0.5 * n}))
    return out


def pore_states(S):
    """bench.py _pore_states: S (p, beta) pore targets over the basin flip."""
    return np.linspace(0.0, 0.1, S), np.linspace(0.92, 1.08, S)[::-1].copy()


def pore_prod_entries(H=96, N=385):
    """bench.py _pore_joint_prod: the two-hill surface at 96 x 385."""
    n1, n2 = 0.25 * (N - 1), 0.72 * (N - 1)
    h1, h2 = 0.25 * H, 0.7 * H
    wn = (0.12 * (N - 1)) ** 2
    wh = (0.2 * H) ** 2
    g1_0 = np.exp(-(n1**2) / wn)
    g2_0 = np.exp(-(n2**2) / wn)
    out = []
    for i in range(H):
        nmax = min(int(0.55 * (N - 1)) + int(i * 0.5 * (N - 1) / H), N - 1)
        n = np.arange(0, nmax + 1, dtype=float)
        G1 = np.exp(-((n - n1) ** 2) / wn) - g1_0
        G2 = np.exp(-((n - n2) ** 2) / wn) - g2_0
        lnpi = 40.0 * np.exp(-((i - h1) ** 2) / wh) * G1 + 55.0 * np.exp(-((i - h2) ** 2) / wh) * G2
        out.append((float(i + 1), lnpi, n.astype(int), {"N_tot": n, "U": -0.5 * n}))
    return out


def pore_states_prod(S):
    """bench.py _pore_states_prod: S (p, beta) targets on the 96 x 385 pore."""
    return np.linspace(0.0, 0.02, S), np.linspace(0.92, 1.08, S)[::-1].copy()


def pore_grid_prod(n):
    """n x n (p, beta) states over pore_states_prod's ranges, flattened."""
    p, b = np.meshgrid(np.linspace(0.0, 0.02, n), np.linspace(0.92, 1.08, n)[::-1])
    return p.ravel().copy(), b.ravel().copy()


JOINT_BETA = 1.1
JOINT_MU_REF = (0.2, -0.3)


def joint_prod_entries(H=96, N=385):
    """bench.py _joint_prod: a binary lnPI(N_1, N_tot) with a vapor-like and
    a species-1-rich liquid-like basin, ragged rows N_tot >= N_1, sampled at
    JOINT_BETA and JOINT_MU_REF."""
    n_v, n_l = 0.16 * (N - 1), 0.72 * (N - 1)
    h_v, h_l = 0.08 * H, 0.33 * H
    wn = (0.1 * (N - 1)) ** 2
    wh = (0.12 * H) ** 2
    out = []
    for i in range(H):
        nt = np.arange(i, N, dtype=float)
        vap = 30.0 * np.exp(-((i - h_v) ** 2) / wh) * np.exp(-((nt - n_v) ** 2) / wn)
        liq = 33.0 * np.exp(-((i - h_l) ** 2) / wh) * np.exp(-((nt - n_l) ** 2) / wn)
        lnpi = vap + liq - 0.08 * nt - 0.3 * i - 8.0 * np.exp(-(nt - i) / 4.0)
        out.append((float(i), lnpi, nt.astype(int), {"N_tot": nt, "N_1": np.full(nt.shape, float(i)), "U": -0.4 * nt}))
    return out


def joint_states(S):
    """bench.py _joint_states: S (mu_1, mu_2) targets in the two-basin window."""
    return np.stack([np.linspace(0.1, 0.4, S), np.linspace(-0.35, -0.25, S)], axis=1)


def joint_grid(n):
    """n x n (mu_1, mu_2) targets over joint_states' window, [n * n, 2]."""
    m1, m2 = np.meshgrid(np.linspace(0.1, 0.4, n), np.linspace(-0.35, -0.25, n))
    return np.stack([m1.ravel(), m2.ravel()], axis=1)


TWO_BASIN_BETA = 1.1
TWO_BASIN_MU_REF = (0.2, -0.3)


def two_basin_entries():
    """test_joint_pipeline.py _two_basin_joint: lnPI(N_1, N_tot), a
    vapor-like and a liquid-like bump, ragged rows N_tot >= N_1."""
    H, N = 12, 25
    out = []
    for i in range(H):
        nt = np.arange(i, N, dtype=float)
        b1 = 30.0 * np.exp(-((i - 2.0) ** 2) / 6.0) * np.exp(-((nt - 4.0) ** 2) / 8.0)
        b2 = 33.0 * np.exp(-((i - 8.0) ** 2) / 6.0) * np.exp(-((nt - 18.0) ** 2) / 8.0)
        out.append((float(i), b1 + b2 - 0.05 * nt, nt.astype(int), {"N_tot": nt, "N_1": np.full(nt.shape, float(i)), "U": -0.4 * nt}))
    return out


def rand_surface(rng, H, N, nb):
    """test_device_watershed.py _rand_surface (rng: np.random.RandomState):
    nb Gaussian bumps plus a deterministic tilt that makes every value
    distinct without adding maxima."""
    y, x = np.mgrid[0:H, 0:N]
    z = np.zeros((H, N))
    for _ in range(nb):
        cy, cx = rng.rand() * H, rng.rand() * N
        amp = 5 + 30 * rng.rand()
        sy, sx = 2 + 4 * rng.rand(), 3 + 8 * rng.rand()
        z += amp * np.exp(-((y - cy) ** 2 / (2 * sy**2) + (x - cx) ** 2 / (2 * sx**2)))
    z += 1e-7 * (y * 1.3 + x * 0.7)
    return z


def tie_joint(jh):
    """``jh`` made, with an exact within-row plateau pair (test_device_watershed
    _tied_pore_joint): a pore build's shift is constant along a row, so the
    tie survives every (p, beta) state."""
    jh.make()
    ln = np.asarray(jh.data["ln(PI)"], dtype=float)
    ln[6, 8] = ln[6, 7]
    jh.data["ln(PI)"] = ln
    return jh


# The 2-D path's cells: surface builder, states, sweep and knobs.  pore13
# and pore96 run pore_state_sweep with F(h) = polynomial([0.1, 0.0]), A = 1;
# joint96 runs joint_state_sweep at JOINT_BETA, JOINT_MU_REF on a surface
# made once.  nnebr 1 and max_peaks 4 everywhere, as the JAX bench.
CELLS2D = {
    "pore13": dict(kind="pore", entries=pore13_entries, states=pore_states, S=64),
    "pore96": dict(kind="pore", entries=pore_prod_entries, states=pore_states_prod, S=64, grid=pore_grid_prod),
    "joint96": dict(kind="joint", entries=joint_prod_entries, states=joint_states, S=64, grid=joint_grid),
}
FH_COEFFS = [0.1, 0.0]


def joint_class_oracle(jh_made, beta, mu_ref, mu_t, nnebr, max_peaks, pore_hist_cls=None):
    """The numpy class engine's phase_average on one joint GC state: the
    surface reweighted and normalized in numpy (bench.py _joint_numpy_state's
    first lines), then the port's pore_hist(engine="numpy") steps on it --
    its normalize, host watershed, per-phase thermo, ridge guard and
    transition-state loop.  (A joint surface's rows start at N_tot = N_1,
    which the class's constructor refuses, so its data is set directly.)"""
    if pore_hist_cls is None:
        from fhmcanalysis_torch.two_dim import pore_hist as pore_hist_cls
    hd = jh_made.data
    lnpi_raw = np.asarray(hd["ln(PI)"], dtype=np.float64)
    valid = np.isfinite(lnpi_raw)
    n1 = np.asarray(hd["op_1"])[:, None]
    n2 = np.asarray(hd["op_2"])[None, :] - n1
    x = np.where(valid, lnpi_raw + beta * ((mu_t[0] - mu_ref[0]) * n1 + (mu_t[1] - mu_ref[1]) * n2), -np.inf)
    m = x[valid].max()
    ph = pore_hist_cls.__new__(pore_hist_cls)
    ph.engine, ph.device = "numpy", None
    ph.data = {"hist": jh_made, "ln(PI)": x - (m + np.log(np.sum(np.exp(x[valid] - m)))), "mask": valid, "edge_idx": np.array(hd["bounds_idx"][:, 1], dtype=int)}
    return ph, ph.phase_average(nnebr=nnebr, max_peaks=max_peaks)


# ---- the example workflows' inputs (examples/torch_*.py) ----

# The binary ideal gas the combining-simulations, multivariable and
# mutual-diffusion notebooks read (reference example/ntot/binary_ideal_gas,
# not in the repository), in closed form: per temperature T and dMu_2 one
# composite at mu_ref = (0, dMu_2), N_tot 0-400 in a box of V = 512,
#   lnPI(N) = N ln(V (z_1 + z_2)) - ln N!,   z_1 = exp(beta mu_1),
#   z_2 = KAPPA exp(beta mu_2),
# moments the binomial moments of N_1 given N_tot with p = z_1/(z_1 + z_2),
# N_2 = N_tot - N_1, U = 0.  The dMu_2 values are the keys
# examples/multivariable_extrapolation.py reads.  KAPPA = (Lambda_1 /
# Lambda_2)^3 = 1.01, species 2 a little heavier than species 1: with
# equal species x_1 = 1/2 holds exactly on the grid row dMu_2 = 0 of
# examples/mutual_diffusion.py, so its x_1 = 0.5 contour runs through grid
# nodes, marching squares returns repeated points and the script's cubic
# interp1d raises; simulated data is never exact there.  The scripts'
# closed forms (x_1 = 1/(1 + exp(beta dMu_2)), P = (z_1 + z_2)/beta with
# KAPPA = 1) then hold within 0.3% and 0.5%, inside their asserts.
IDEAL_GAS = dict(V=512.0, N=401, max_order=3, T=(1.20, 1.00), dmu2=(-2.94, -1.10, 0.00, 1.10, 2.94), kappa=1.01)


def _lgamma(x):
    import math

    x = np.asarray(x, dtype=np.float64)
    return np.array([math.lgamma(v) for v in x.ravel()]).reshape(x.shape)


def ideal_gas_composite(T: float, dmu2: float, V: float = IDEAL_GAS["V"], N: int = IDEAL_GAS["N"], max_order: int = IDEAL_GAS["max_order"], kappa: float = IDEAL_GAS["kappa"]) -> dict:
    """The binary ideal gas at (T, dMu_2) as a ``read_composite`` dict."""
    beta = 1.0 / T
    z1, z2 = 1.0, kappa * np.exp(beta * dmu2)
    p = z1 / (z1 + z2)
    n = np.arange(N, dtype=np.float64)
    lnpi = n * np.log(V * (z1 + z2)) - _lgamma(n + 1.0)
    mo1 = max_order + 1
    # <N_1^a N_2^b> over the binomial law of N_1 at each N_tot
    pw = np.zeros((2 * max_order + 1, 2 * max_order + 1, N))
    for t in range(N):
        k = np.arange(t + 1, dtype=np.float64)
        pmf = np.exp(_lgamma(t + 1.0) - _lgamma(k + 1.0) - _lgamma(t - k + 1.0) + k * np.log(p) + (t - k) * np.log1p(-p))
        for a in range(2 * max_order + 1):
            for b in range(2 * max_order + 1 - a):
                pw[a, b, t] = np.sum(pmf * k**a * (t - k) ** b)
    pw[0, 0] = 1.0
    mom = np.zeros((2, mo1, 2, mo1, mo1, N))
    for i, j, k, m in np.ndindex(2, mo1, 2, mo1):
        a = (j if i == 0 else 0) + (m if k == 0 else 0)
        mom[i, j, k, m, 0] = pw[a, j + m - a]
    return {"history": "binary ideal gas, T = %.2f, dMu2 = %.2f" % (T, dmu2), "volume": float(V), "nspec": 2,
            "max_order": int(max_order), "lnpi": lnpi, "op": np.arange(N, dtype=np.int64), "mom": mom}


def ideal_gas_sources(T: float) -> dict:
    """{dMu_2: read_composite dict} of the simulations at temperature T."""
    return {d: ideal_gas_composite(T, d) for d in IDEAL_GAS["dmu2"]}


def write_ideal_gas(root: str) -> str:
    """The data tree root/T_%.2f/dMu2_%.2f/composite.nc of every temperature
    (netCDF through the port's io, which needs h5py); returns root."""
    import os

    from fhmcanalysis_torch.io import write_composite

    for T in IDEAL_GAS["T"]:
        for d, raw in ideal_gas_sources(T).items():
            path = os.path.join(root, "T_%.2f" % T, "dMu2_%.2f" % d)
            os.makedirs(path, exist_ok=True)
            write_composite(os.path.join(path, "composite.nc"), raw["lnpi"], raw["op"], raw["mom"], raw["volume"], 2, raw["max_order"], history=raw["history"])
    return root
