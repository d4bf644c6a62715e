"""The benchmark's frozen generator of the slit-pore surface lnPI(h, N_tot).

numpy only, and independent of the program, of the JAX bench and of the
test suite: the yardstick's inputs may not move when any of them does.

The surface is the two-basin geometry of a production-scale slit pore:
H pore widths h = 1..H, rows N_tot = 0..nmax(h) that lengthen with the
width (a ragged edge), and two Gaussian hills whose relative stability
flips with the applied pressure p.  lnPI[h, 0] is 0 on every row.  Three
numbers drawn from the seed move the hills' heights and the energy
profile U(h, N) by a few percent: continuous values, so that two cells
of one footprint window share an elevation only by accident, and never
the number of hills.  N_tot stays the order parameter itself.
"""

from __future__ import annotations

import numpy as np

# the hills' heights and the energy per particle before the seed moves them
HEIGHTS = (40.0, 55.0)
U_PER_N = -0.5
SHARE = 0.03  # how far the seed moves each of them, as a share


def rows(H: int, N: int, seed: int) -> list:
    """The surface as H joint-histogram rows (op_1, lnPI, N_tot values,
    properties), h = op_1 = 1..H, drawn from seed."""
    c = np.random.default_rng(seed).uniform(-SHARE, SHARE, size=3)
    n1, n2 = 0.25 * (N - 1), 0.72 * (N - 1)
    h1, h2 = 0.25 * H, 0.7 * H
    wn = (0.12 * (N - 1)) ** 2
    wh = (0.2 * H) ** 2
    g1_0 = np.exp(-(n1**2) / wn)
    g2_0 = np.exp(-(n2**2) / wn)
    out = []
    for i in range(H):
        nmax = min(int(0.55 * (N - 1)) + int(i * 0.5 * (N - 1) / H), N - 1)
        n = np.arange(0, nmax + 1, dtype=np.float64)
        G1 = np.exp(-((n - n1) ** 2) / wn) - g1_0
        G2 = np.exp(-((n - n2) ** 2) / wn) - g2_0
        lnpi = HEIGHTS[0] * (1 + c[0]) * np.exp(-((i - h1) ** 2) / wh) * G1 + HEIGHTS[1] * (1 + c[1]) * np.exp(-((i - h2) ** 2) / wh) * G2
        u = U_PER_N * (1 + c[2] * np.sin(3.0 * n / (N - 1) + i / H)) * n
        out.append((float(i + 1), lnpi, n.astype(int), {"N_tot": n, "U": u}))
    return out


def assemble(rows_: list) -> dict:
    """The rows on one padded [H, N] surface, as a joint histogram holds
    them: lnpi (-inf past each row's edge), h (op_1), edge (the last
    N_tot column of each row), props (name -> [H, N], 0 past the edge)."""
    H = len(rows_)
    N = max(len(r[1]) for r in rows_)
    lnpi = np.full((H, N), -np.inf)
    names = sorted(rows_[0][3])
    props = {k: np.zeros((H, N)) for k in names}
    for i, (_, ln, ops, pr) in enumerate(rows_):
        lnpi[i, ops] = ln
        for k in names:
            props[k][i, ops] = pr[k]
    return {"lnpi": lnpi, "h": np.array([r[0] for r in rows_]), "edge": np.array([r[2][-1] for r in rows_]), "props": props}
