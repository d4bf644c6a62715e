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

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
# -fmad=false: no FMA contraction anywhere, so the kernels round every
# product and sum as the plain PyTorch versions do
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-fmad=false", "--ptxas-options=-v", "-shared", "-Xcompiler", "-fPIC")

# seconds and compiler output of the builds this process ran, by name
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
def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    so = library_path(name)
    if not so.exists():
        BUILD_DIR.mkdir(exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(CSRC / f"{name}.cu")], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed to build {name}.cu:\n{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, so)
        BUILD_INFO[name] = {"seconds": time.perf_counter() - t0, "log": proc.stdout + proc.stderr}
    return ctypes.CDLL(str(so))
