"""Order-parameter-axis sharding of dense surfaces.

The PyTorch port of the JAX package's ``parallel/surface.py``.  Very long
1-D lnPI surfaces and dense 2-D lnPI(h, N) pore surfaces split along one
order-parameter axis over the mesh's devices.  The only halo exchange of
the whole workload is the +-smooth strict-compare stencil of relextrema
(ntot/gc_hist.pyx:329-330): each block borrows its neighbours' smooth-wide
edge strips, copied between devices, and the outer ends are filled with
the surface's first and last values (argrelextrema's clip mode).
Everything else is elementwise or a global reduction (normalize), done as
a reduction over the per-shard partials on the mesh's first device.  The
extrema extraction (endpoint repairs, alternation checks,
segment.extrema_from_flags) runs once on the gathered surface and flags:
its repair branches take arg-extrema over arbitrary gaps of lnPI.

As in mesh.py, a sharded result comes back as a list of per-device blocks
in mesh order, the port's stand-in for the JAX package's sharded array.
Every function takes a 1-D lnPI (or the 2-D pore surface, split by rows)
whose split axis is divisible by the mesh's device count.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.segment import Extrema, extrema_from_flags, stencil_flags
from .mesh import GridMesh, _blocks

__all__ = [
    "sharded_normalize_long",
    "sharded_stencil_flags",
    "sharded_relextrema",
    "sharded_normalize_2d",
]


def _check_len(n: int, d: int, what: str):
    if n % d:
        raise ValueError("%s length %d not divisible by %d devices" % (what, n, d))


def _tensor(x) -> torch.Tensor:
    return x if torch.is_tensor(x) else torch.as_tensor(np.asarray(x))


def _split(mesh: GridMesh, x: torch.Tensor, what: str) -> list:
    """x's leading axis in one equal block per mesh device, each on its device."""
    devs = mesh.device_list()
    _check_len(x.shape[0], len(devs), what)
    return [b.to(d) for b, d in zip(_blocks(x, len(devs)), devs)]


def _first(mesh: GridMesh) -> torch.device:
    return mesh.device_list()[0]


def sharded_normalize_long(mesh: GridMesh, lnpi) -> list:
    """numerics.normalize_lnpi for a 1-D lnPI split over the N axis: the
    global max of the per-shard maxima, then the sum of the per-shard sums
    of exp(x - max); each block is shifted by max + log(sum).

    Parity: histogram.normalize (gc_hist.pyx:57-67).  Returns the
    normalized blocks, one per device.
    """
    xs = _split(mesh, _tensor(lnpi), "lnpi")
    dev = _first(mesh)
    m = torch.stack([x.max().to(dev) for x in xs]).max()
    s = torch.stack([torch.exp(x - m.to(x.device)).sum().to(dev) for x in xs]).sum()
    shift = m + torch.log(s)
    return [x - shift.to(x.device) for x in xs]


def _local_flags(xs: list, j: int, smooth: int, x_first, x_last):
    """(is_max, is_min) of block j of a surface split into equal blocks
    ``xs``, from the block and its neighbours' edge strips (smooth < the
    block's length), with clip-mode fills x_first / x_last at the ends."""
    xl = xs[j]
    L, dev = xl.shape[0], xl.device
    left = xs[j - 1][-smooth:].to(dev) if j > 0 else x_first.to(dev).expand(smooth)
    right = xs[j + 1][:smooth].to(dev) if j < len(xs) - 1 else x_last.to(dev).expand(smooth)
    padded = torch.cat([left, xl, right])  # [L + 2 smooth]
    is_max = torch.ones(L, dtype=torch.bool, device=dev)
    is_min = torch.ones(L, dtype=torch.bool, device=dev)
    for k in range(1, smooth + 1):
        up = padded[smooth + k : smooth + k + L]
        dn = padded[smooth - k : smooth - k + L]
        is_max = is_max & (xl > up) & (xl > dn)
        is_min = is_min & (xl < up) & (xl < dn)
    return is_max, is_min


def _flags(mesh: GridMesh, xs: list, smooth: int):
    """Per-shard stencil flags of the blocks xs; when the halo is at least a
    block (smooth >= L) every block's flags come from the gathered surface."""
    if smooth < 1:
        raise ValueError("smooth must be >= 1 to find relative extrema (scipy argrelextrema rejects order 0 too)")
    L = xs[0].shape[0]
    if smooth >= L:
        dev = _first(mesh)
        fmax, fmin = stencil_flags(torch.cat([x.to(dev) for x in xs])[None], smooth)
        return [f.to(x.device) for f, x in zip(fmax[0].split(L), xs)], [f.to(x.device) for f, x in zip(fmin[0].split(L), xs)]
    x_first, x_last = xs[0][0], xs[-1][-1]
    flags = [_local_flags(xs, j, smooth, x_first, x_last) for j in range(len(xs))]
    return [f[0] for f in flags], [f[1] for f in flags]


def sharded_stencil_flags(mesh: GridMesh, lnpi, smooth: int):
    """segment.stencil_flags of a 1-D lnPI with the N axis split over the
    mesh and the +-smooth halo taken from the neighbours' edge strips.
    Returns (is_max blocks, is_min blocks), one block per device."""
    return _flags(mesh, _split(mesh, _tensor(lnpi), "lnpi"), smooth)


def sharded_relextrema(mesh: GridMesh, lnpi, smooth: int, max_phases: int) -> Extrema:
    """segment.relextrema of a long 1-D lnPI: the split stencil (halo
    exchange), then the extraction once on the gathered surface and flags
    on the mesh's first device.  Returns the Extrema of the one surface
    (maxima i32[P], n_max i32[], minima i32[P+1], n_min i32[], valid
    bool[]), equal to segment.relextrema(lnpi[None], ...)'s first row."""
    xs = _split(mesh, _tensor(lnpi), "lnpi")
    fmax, fmin = _flags(mesh, xs, smooth)
    dev = _first(mesh)

    def whole(parts):
        return torch.cat([p.to(dev) for p in parts])[None]

    ext = extrema_from_flags(whole(xs), whole(fmax), whole(fmin), max_phases)
    return Extrema(**{f: getattr(ext, f)[0] for f in Extrema.__dataclass_fields__})


def sharded_normalize_2d(mesh: GridMesh, lnpi2d, valid_mask) -> list:
    """Masked 2-D pore normalization (segment2d.normalize_2d of one
    surface) with the h axis split over the mesh: a masked max over the row
    shards, then a masked sum of exp(x - max).

    Parity: pore_hist normalize (pore_hist.pyx:57-80) -- one masked
    logsumexp over the ragged valid region of lnPI(h, N); valid_mask marks
    the in-bounds (h, N) cells.  Returns the normalized row blocks, one per
    device.
    """
    x = _tensor(lnpi2d)
    xs = _split(mesh, x, "lnpi2d rows")
    ms = [b.to(d.device) for b, d in zip(_blocks(_tensor(valid_mask).to(torch.bool), len(xs)), xs)]
    dev = _first(mesh)
    m = torch.stack([torch.where(mk, xl, -torch.inf).max().to(dev) for xl, mk in zip(xs, ms)]).max()
    s = torch.stack([torch.where(mk, torch.exp(xl - m.to(xl.device)), 0.0).sum().to(dev) for xl, mk in zip(xs, ms)]).sum()
    shift = m + torch.log(s)
    return [xl - shift.to(xl.device) for xl in xs]
