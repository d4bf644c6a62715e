"""Minimal netCDF4 (HDF5-backed) reader/writer built on h5py.

The composite-histogram schema this module reads/writes mirrors the one the
reference produces in fhmc_patch.pyx:551-634 (``to_nc``) and consumes in
ntot/gc_hist.pyx:131-182 (``reload``): variables ``ln(PI)``, the order
parameter (``N_{tot}`` or ``N_{1}``), the 6-D moments tensor
``N_{i}^{j}*N_{k}^{m}*U^{p}``, optional particle-number / energy
sub-histograms with their lb/ub/bw arrays, and global attrs ``history``,
``volume``, ``nspec``, ``max_order``.

netCDF4 files *are* HDF5 files; h5py reads them directly.  For writing we
emit HDF5 with netCDF-4 dimension-scale conventions so the output stays
readable by the netCDF4 library (and by this module).

The PyTorch port's copy of the JAX package's ``io/netcdf.py``, schema for
schema.  ``h5py`` is imported inside the functions that touch a file, so
the package imports on a machine without it (composites then come from
in-memory dicts, ``histogram.from_composite``).
"""

from __future__ import annotations

import time

import numpy as np

__all__ = ["NCFile", "read_composite", "write_composite"]


def _scalar_attr(value):
    """netCDF4 stores scalar attrs as 1-element arrays; unwrap them."""
    arr = np.asarray(value)
    if arr.ndim == 0:
        return arr[()]
    if arr.size == 1:
        return arr.reshape(-1)[0]
    return arr


class NCFile:
    """Read-only view over a netCDF4/HDF5 file with dict-like variables.

    Provides the small surface the reference uses from netCDF4.Dataset:
    ``variables[name][:]`` plus attribute access for globals (``history``,
    ``volume``, ``nspec``, ``max_order``).
    """

    def __init__(self, fname: str):
        import h5py

        self._f = h5py.File(fname, "r")
        self.variables = {k: self._f[k] for k in self._f.keys()}

    def __getattr__(self, name):
        try:
            v = self._f.attrs[name]
        except KeyError as e:
            raise AttributeError(name) from e
        v = _scalar_attr(v)
        if isinstance(v, bytes):
            return v.decode()
        return v

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_composite(fname: str, op_name: str = "N_{tot}") -> dict:
    """Load a composite histogram file into a dict of numpy arrays.

    Parameters
    ----------
    fname : path to composite .nc file
    op_name : order-parameter variable name ("N_{tot}" or "N_{1}")

    Returns dict with keys: lnpi, op, mom, history, volume, nspec,
    max_order, and (when present) pk_hist / e_hist sub-dicts with
    hist/lb/ub/bw arrays.  Mirrors gc_hist.pyx:131-182.
    """
    out = {}
    with NCFile(fname) as ds:
        out["history"] = ds.history
        out["volume"] = float(ds.volume)
        out["nspec"] = int(ds.nspec)
        out["max_order"] = int(ds.max_order)
        out["lnpi"] = np.array(ds.variables["ln(PI)"][:], dtype=np.float64)
        out["op"] = np.array(ds.variables[op_name][:], dtype=np.int64)
        out["mom"] = np.array(ds.variables["N_{i}^{j}*N_{k}^{m}*U^{p}"][:], dtype=np.float64)

        pk_name = "P_{N_i}(%s)" % op_name
        if pk_name in ds.variables:
            out["pk_hist"] = {
                "hist": np.array(ds.variables[pk_name][:]),
                "lb": np.array(ds.variables[pk_name + "_{lb}"][:]),
                "ub": np.array(ds.variables[pk_name + "_{ub}"][:]),
                "bw": np.array(ds.variables[pk_name + "_{bw}"][:]),
            }
        e_name = "P_{U}(%s)" % op_name
        if e_name in ds.variables:
            out["e_hist"] = {
                "hist": np.array(ds.variables[e_name][:]),
                "lb": np.array(ds.variables[e_name + "_{lb}"][:]),
                "ub": np.array(ds.variables[e_name + "_{ub}"][:]),
                "bw": np.array(ds.variables[e_name + "_{bw}"][:]),
            }
    return out


def _make_dim(f, name: str, size: int, values=None, dimid: int = 0):
    """Create a netCDF-4 style dimension-scale dataset."""
    if values is None:
        values = np.arange(size, dtype=np.int64)
    d = f.create_dataset(name, data=values)
    d.attrs["CLASS"] = np.bytes_(b"DIMENSION_SCALE")
    d.attrs["NAME"] = np.bytes_(name.encode())
    d.attrs["_Netcdf4Dimid"] = np.int32(dimid)
    return d


def _attach(var, dims):
    for i, d in enumerate(dims):
        var.dims[i].attach_scale(d)


def write_composite(
    fname: str,
    lnpi: np.ndarray,
    op: np.ndarray,
    mom: np.ndarray,
    volume: float,
    nspec: int,
    max_order: int,
    op_name: str = "N_{tot}",
    pk_hist: dict | None = None,
    e_hist: dict | None = None,
    history: str | None = None,
):
    """Write a composite histogram in the reference netCDF schema.

    Schema parity with fhmc_patch.pyx:562-633: dims (op, i, j, k, m, p[,
    bin]), vars ln(PI), op, moments tensor, optional P_{N_i}/P_{U}
    sub-histogram blocks, global attrs history/volume/nspec/max_order.
    """
    import h5py

    lnpi = np.asarray(lnpi, dtype=np.float64)
    op = np.asarray(op)
    mom = np.asarray(mom, dtype=np.float64)
    if history is None:
        history = "Created " + time.ctime(time.time())

    with h5py.File(fname, "w") as f:
        f.attrs["history"] = np.bytes_(history.encode())
        f.attrs["volume"] = np.array([float(volume)])
        f.attrs["nspec"] = np.array([int(nspec)])
        f.attrs["max_order"] = np.array([int(max_order)])

        n = len(lnpi)
        mo1 = max_order + 1
        d_op = _make_dim(f, op_name, n, values=np.asarray(op, dtype=np.int64), dimid=0)
        d_i = _make_dim(f, "i", nspec, dimid=1)
        d_j = _make_dim(f, "j", mo1, dimid=2)
        d_k = _make_dim(f, "k", nspec, dimid=3)
        d_m = _make_dim(f, "m", mo1, dimid=4)
        d_p = _make_dim(f, "p", mo1, dimid=5)

        v = f.create_dataset("ln(PI)", data=lnpi)
        _attach(v, [d_op])
        v = f.create_dataset("N_{i}^{j}*N_{k}^{m}*U^{p}", data=mom)
        _attach(v, [d_i, d_j, d_k, d_m, d_p, d_op])

        d_bin = None
        for tag, sub in (("P_{N_i}(%s)" % op_name, pk_hist), ("P_{U}(%s)" % op_name, e_hist)):
            if sub is None:
                continue
            hist = np.asarray(sub["hist"], dtype=np.float64)
            nbins = hist.shape[-1]
            if d_bin is None:
                d_bin = _make_dim(f, "bin", nbins, values=np.arange(nbins, dtype=np.float32), dimid=6)
            if hist.ndim == 3:  # per-species pk hist: (nspec, n, bins)
                dims = [d_i, d_op, d_bin]
                sdims = [d_i, d_op]
            else:  # energy hist: (n, bins)
                dims = [d_op, d_bin]
                sdims = [d_op]
            v = f.create_dataset(tag, data=hist)
            _attach(v, dims)
            for suffix in ("lb", "ub", "bw"):
                v = f.create_dataset(tag + "_{%s}" % suffix, data=np.asarray(sub[suffix], dtype=np.float64))
                _attach(v, sdims)
