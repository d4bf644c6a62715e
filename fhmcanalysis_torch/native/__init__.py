"""Native (C++) host code: the window-file table reader and the 2-D
watershed flood, each with a Python fallback.

The PyTorch port's copy of the JAX package's ``native/__init__.py``.
``fast_table.cpp`` (``read_table``, the parser of the window loaders in
``win_patch``) and ``imaging.cpp`` (the priority flood of
``two_dim.imaging``) are compiled with g++ on first use into
``fhmcanalysis_torch/_build/`` (gitignored), keyed by a hash of the source
and the flags, so an edited source rebuilds and an unchanged one loads at
once.  If no compiler or Python headers are available, ``np.loadtxt`` and
the heapq flood run instead; both give the same results.
``NATIVE_AVAILABLE`` and ``IMAGING_AVAILABLE`` report which runs.
"""

from __future__ import annotations

import hashlib
import importlib.util
import os
import subprocess
import sys
import sysconfig
import threading
from pathlib import Path

import numpy as np

__all__ = ["read_table", "loadtxt_unpacked", "watershed_native", "NATIVE_AVAILABLE", "IMAGING_AVAILABLE"]

_HERE = Path(__file__).resolve().parent
BUILD_DIR = _HERE.parent / "_build"
_TAG = "cp%d%d" % sys.version_info[:2]
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_cache: dict = {}
# one build at a time in a process: the host flood's threads reach _load
# together on a cold _build/, and two builds of one file would share its
# temporary name
_build_lock = threading.Lock()


def _compile(src_name: str, mod_name: str) -> Path | None:
    src = _HERE / src_name
    # the numpy version is in the key: the extension is built against its headers
    h = hashlib.sha256(" ".join((*GXX_FLAGS, np.__version__)).encode() + src.read_bytes()).hexdigest()[:16]
    so = BUILD_DIR / ("%s_%s_%s.so" % (mod_name, _TAG, h))
    if so.exists():
        return so
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = so.with_name("%s.%d.tmp" % (so.name, os.getpid()))
    cmd = ["g++", *GXX_FLAGS, "-I", sysconfig.get_path("include"), "-I", np.get_include(), str(src), "-o", str(tmp)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        return None
    os.replace(tmp, so)  # atomic: a concurrent process loads a whole file or builds its own
    return so


def _load(src_name: str, mod_name: str):
    if mod_name in _cache:
        return _cache[mod_name]
    with _build_lock:
        if mod_name not in _cache:
            _cache[mod_name] = _build(src_name, mod_name)
    return _cache[mod_name]


def _build(src_name: str, mod_name: str):
    so = _compile(src_name, mod_name)
    mod = False
    if so is not None:
        spec = importlib.util.spec_from_file_location(mod_name, so)
        try:
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
        except ImportError:
            mod = False
    return mod


def numpy_table(path: str, comment: str = "#") -> np.ndarray:
    """The fallback parser of ``read_table``: np.loadtxt to f64 [rows, cols]."""
    return np.loadtxt(path, dtype=np.float64, comments=comment, ndmin=2)


def read_table(path: str, comment: str = "#") -> np.ndarray:
    """Parse a whitespace-delimited numeric table to f64 [rows, cols].

    Native when available, np.loadtxt otherwise; both reject ragged rows
    and non-numeric fields (ValueError).
    """
    mod = _load("fast_table.cpp", "_fhmc_native")
    if mod:
        return mod.read_table(path, comment=comment)
    return numpy_table(path, comment)


def loadtxt_unpacked(path: str) -> np.ndarray:
    """np.loadtxt(path, unpack=True) equivalent on the fast path.

    Returns [cols, rows] like unpack=True; single-column files come back
    1-D to match numpy semantics (the window loaders rely on this).
    """
    out = read_table(path).T
    if out.shape[0] == 1:
        return out[0]
    return out


def watershed_native(image, markers, mask, offsets):
    """Priority-flood watershed (imaging.cpp), or None when it cannot be built.

    Flood order matches two_dim.imaging.watershed's heapq implementation
    exactly — the two paths produce bit-identical label maps.  Elevations
    must be NaN-free (heap comparators have undefined NaN ordering);
    two_dim.imaging.watershed normalizes NaN to +inf before calling.
    """
    mod = _load("imaging.cpp", "_fhmc_imaging")
    if not mod:
        return None
    return mod.watershed(
        np.ascontiguousarray(image, dtype=np.float64),
        np.ascontiguousarray(markers, dtype=np.int64),
        np.ascontiguousarray(mask, dtype=bool),
        np.ascontiguousarray(offsets, dtype=np.int64),
    )


def __getattr__(name):
    # lazy: each extension compiles on first use, not at package import
    if name == "NATIVE_AVAILABLE":
        return bool(_load("fast_table.cpp", "_fhmc_native"))
    if name == "IMAGING_AVAILABLE":
        return bool(_load("imaging.cpp", "_fhmc_imaging"))
    raise AttributeError(name)
