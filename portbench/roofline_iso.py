"""The work of one isopleth lattice for kernel K3's roofline share, counted
as roofline.py counts the sweeps' (from what the user hands make_grid and
gets back), with roofline.py's peaks and tail."""

from __future__ import annotations

import numpy as np

from portbench import roofline as R
from portbench.reference import iso


def k3_ops(order: int) -> tuple[int, int]:
    """(x_ops, key_ops) of a cell: two sides' x' (K2's reweight, dB, dd and
    order-2 terms) and their mix (2 products, a sum, a divide); per key row
    two sides' key', the mix and the multiply-add."""
    o2 = 7 if order == 2 else 0
    return 2 * (2 + 4 + 2 + o2) + 4, 3 * (2 * (4 + o2) + 4 + 2)


def sources_named(src_dmu2, dmu2_axis) -> int:
    """The sources that the rows of a lattice bracket (make_grid reads
    each once)."""
    src = np.array(sorted(float(d) for d in src_dmu2))
    return len({j for v in dmu2_axis for j in iso.bracket(src, float(v))})


def lattice_bytes(W: int, rows: int, N: int, NX: int, NY: int) -> int:
    """Bytes read and written once: each of the W sources' lnPI, op and the
    moment rows its Taylor rows read; the mu_1 and dMu_2 axes; lr (int32)
    and the weights per row; x_1, density and F.E./kT (f64), valid (bool)
    and fail_code (int32) per cell."""
    return W * (2 + rows) * N * R.F64 + (NX + NY) * R.F64 + NY * 2 * (R.I32 + R.F64) + NX * NY * (3 * R.F64 + R.BOOL + R.I32)


def lattice_ops(NX: int, NY: int, N: int, smooth: int, order: int) -> int:
    """f64 operations of K3 over the lattice, every cell one phase over its
    N bins (the ig401 lattice: tests/test_torch_iso_reference.py checks
    it)."""
    B = NX * NY
    return R.tail_ops(B, N, smooth, B * N, *k3_ops(order))
