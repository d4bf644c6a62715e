"""Moment-address algebra of the moments tensor N_i^j N_k^m U^p: which
stored moment equals the product of two (FHMCAnalysis
ntot/gc_hist.pyx:1515-1658), a frozen copy for the plain reference.
"""

from __future__ import annotations

from functools import lru_cache

Addr = tuple[int, int, int, int, int]


def order_mom_address(idx) -> Addr:
    """Canonically order an (i,j,k,m,p) address by species index.

    N2^j*N1^m -> N1^m*N2^j; the energy power p is unaffected.
    Parity: gc_hist.pyx:1515-1544.
    """
    i, j, k, m, p = idx
    if i > k:
        return (k, m, i, j, p)
    return (i, j, k, m, p)


@lru_cache(maxsize=None)
def mom_prod(x_idx: Addr, y_idx: Addr, nspec: int, max_order: int) -> Addr:
    """Address of the moment equal to the product of two moments.

    Valid for pure and binary mixtures only (gc_hist.pyx:1566).  Applies
    same-species folding (Nx^j*Nx^m -> Nx^{j+m}), canonical ordering, then
    combines; finally uses the N_i <-> N_k symmetry to keep exponents within
    max_order.  Raises if the product order is out of range — the callers
    gate addresses so this never fires for in-gate work (parity with the
    asserts at gc_hist.pyx:1654-1656).
    """
    if nspec > 2:
        raise ValueError("Ordering moment indices is only valid for <=2 components")

    def fold(idx):
        i, j, k, m, p = idx
        if i == k:
            # Nx^j * Nx^m -> Nx^{j+m} * N1^0
            j, m, k = j + m, 0, 0
        return order_mom_address((i, j, k, m, p))

    x = fold(tuple(x_idx))
    y = fold(tuple(y_idx))

    # After folding/ordering each operand is N1^a (k==0, m==0 form collapsed
    # onto species arrangement with i<=k) or N1^a*N2^b.
    if x[0] == y[0] and x[2] == y[2]:
        z = (x[0], x[1] + y[1], x[2], x[3] + y[3], x[4] + y[4])
    elif x[0] == 0 and x[2] == 0 and y[0] == 0 and y[2] == 1:
        # x is N1-only, y is N1*N2
        z = (y[0], y[1] + (x[1] + x[3]), y[2], y[3], y[4] + x[4])
    elif x[0] == 0 and x[2] == 1 and y[0] == 0 and y[2] == 0:
        # x is N1*N2, y is N1-only
        z = (x[0], x[1] + (y[1] + y[3]), x[2], x[3], x[4] + y[4])
    else:
        raise ValueError("Bad logic in moment product for %s * %s" % (x, y))

    # Use N_i^j N_k^m symmetry to prevent overflowing max_order
    i, j, k, m, p = z
    if i == k:
        if j > max_order:
            j, m = max_order, j - max_order
        elif m > max_order:
            m, j = max_order, m - max_order
    z = (i, j, k, m, p)

    if j > max_order or m > max_order or p > max_order:
        raise ValueError("Order out of range in moment product: %s" % (z,))
    return z
