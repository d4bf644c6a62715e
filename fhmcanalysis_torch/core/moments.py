"""Static moment-index algebra for the 6-D moments tensor N_i^j N_k^m U^p.

This is pure integer address math (reference: _order_mom_address
ntot/gc_hist.pyx:1515-1544, _mom_prod :1546-1658).  It runs on the host;
addresses are static Python ints that index the moments tensor.  A copy of
the JAX package's module, which cannot be imported without importing JAX.

Semantics reproduced faithfully, including the reference's nspec <= 2
restriction and the symmetry folding that keeps exponents <= max_order.
The reference's ``elif ()`` branches (gc_hist.pyx:1602-1638) are dead code
(empty-tuple conditions are always false); after the same-species folding
step both operands are always of N1^a or N1^a*N2^b form, so those branches
are unreachable here too.
"""

from __future__ import annotations

from functools import lru_cache

Addr = tuple[int, int, int, int, int]

__all__ = ["order_mom_address", "mom_prod", "all_addresses", "gated_addresses"]


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


def all_addresses(nspec: int, max_order: int) -> list[Addr]:
    """Enumerate all (i,j,k,m,p) addresses in tensor order."""
    mo1 = max_order + 1
    return [
        (i, j, k, m, p)
        for i in range(nspec)
        for j in range(mo1)
        for k in range(nspec)
        for m in range(mo1)
        for p in range(mo1)
    ]


def canonical_powers(a: Addr) -> tuple[int, int, int]:
    """Physical identity of a stored moment row: powers (n1, n2, u).

    The 6-D tensor stores N_i^j * N_k^m * U^p, so distinct addresses can
    hold the same physical moment (e.g. (0,1,1,0,p) == (1,0,0,1,p) ==
    N_1^1).  Valid composite files store these bit-identically (the
    simulator writes the same scalar); this key drives exact deduplication
    of the per-phase moment contraction.
    """
    i, j, k, m, p = a
    n1 = (j if i == 0 else 0) + (m if k == 0 else 0)
    n2 = (j if i == 1 else 0) + (m if k == 1 else 0)
    return (n1, n2, p)


def unique_row_map(nspec: int, max_order: int) -> tuple[list[int], list[int]]:
    """(unique_flat_indices, inverse) for deduplicating the flattened
    [A, N] moments matrix by physical identity.  mom2d[unique][inverse]
    reconstructs all A rows."""
    addrs = all_addresses(nspec, max_order)
    first: dict = {}
    uniq: list[int] = []
    inverse: list[int] = []
    for flat, a in enumerate(addrs):
        key = canonical_powers(a)
        if key not in first:
            first[key] = len(uniq)
            uniq.append(flat)
        inverse.append(first[key])
    return uniq, inverse


def gated_addresses(nspec: int, max_order: int, order: int) -> list[Addr]:
    """Addresses whose derivatives of the given order are representable:
    j + m + p + order <= max_order (the gate at gc_hist.pyx:2157, 2198, 2244).
    """
    return [a for a in all_addresses(nspec, max_order) if a[1] + a[3] + a[4] + order <= max_order]
