"""Build the package's CUDA sources at first use and load them with ctypes.

Each ``csrc/<name>.cu`` exports a plain C interface and is compiled by
``nvcc`` (with ``-I csrc``) into ``_build/lib<name>_<hash>.so``, keyed by a
hash of the flags, the source and every shared header ``csrc/*.cuh``, so an
edited source or header rebuilds and an unchanged one loads at once.  Nothing here includes PyTorch's headers, which keeps a build to
seconds.  A failed build raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

from .utils import profiling

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
# -fmad=false: no FMA contraction anywhere, so the kernels round every
# product and sum as the plain PyTorch versions do
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-fmad=false", "--ptxas-options=-v", "-shared", "-Xcompiler", "-fPIC")

# the compiler output of the builds this process ran, by name
BUILD_INFO: dict = {}


def _nvcc() -> str:
    cands = [os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc")] if os.environ.get("CUDA_HOME") else []
    cands += ["/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""]
    for c in cands:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


@functools.lru_cache(maxsize=None)
def load(name: str, declare) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed, with
    ``declare(lib)`` run on it (its C signatures and capacity checks).  The
    build's seconds go to the counters ``kernel.builds`` / ``kernel.build_s``
    and the rest of the load's to ``kernel.loads`` / ``kernel.load_s``
    (utils.profiling)."""
    t0 = time.perf_counter()
    so = library_path(name)
    build_s = None
    if not so.exists():
        BUILD_DIR.mkdir(exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        t1 = time.perf_counter()
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(CSRC / f"{name}.cu")], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed to build {name}.cu:\n{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, so)
        build_s = time.perf_counter() - t1
        BUILD_INFO[name] = {"log": proc.stdout + proc.stderr}
    lib = ctypes.CDLL(str(so))
    declare(lib)
    load_s = time.perf_counter() - t0 - (build_s or 0.0)
    if build_s is not None:
        profiling.add("kernel.builds")
        profiling.add("kernel.build_s", build_s)
    profiling.add("kernel.loads")
    profiling.add("kernel.load_s", load_s)
    return lib
