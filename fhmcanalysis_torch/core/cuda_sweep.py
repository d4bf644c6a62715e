"""The fused mu-sweep kernel (CUDA, Hopper) and its wrapper.

Replaces the TPU kernel ``fhmcanalysis_tpu/core/pallas_sweep.py``
(``_sweep_ds_pallas``), which ran the sweep in double-single f32 pairs
because the TPU has no f64.  The port computes in native f64: the kernel
source is ``csrc/sweep_thermo.cu``, one warp per state point.  On the card
it is bound by f64 ``exp`` (one per bin and point) and the serial
segmentation logic, not by bytes: the composite's rows are a few KB shared
by every point.  The source's header says how the layout answers that.

The plain version of this kernel is ``segment.py`` + ``pipeline._point_thermo``;
nothing on the CUDA path calls it.  ``pipeline.mu_sweep_thermo`` picks
between the two by the tensors' device.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build

NAME = "sweep_thermo"
MAX_PHASES = 8  # the kernel's per-warp arrays; csrc/sweep_thermo.cu MAXP


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared."""
    lib = _build.load(NAME)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.sweep_thermo_launch.argtypes = [i, p, p, p, p, p, p] + [i] * 7 + [p] * 11
    lib.sweep_thermo_launch.restype = i
    lib.sweep_thermo_error_string.argtypes = [i]
    lib.sweep_thermo_error_string.restype = ctypes.c_char_p
    lib.sweep_thermo_max_phases.argtypes = []
    lib.sweep_thermo_max_phases.restype = i
    if lib.sweep_thermo_max_phases() != MAX_PHASES:
        raise RuntimeError("sweep_thermo.cu MAXP disagrees with cuda_sweep.MAX_PHASES")
    return lib


def sweep_thermo(lnpi, op, keys, volume, a, smooth: int, max_phases: int, props: bool = True, collect=None) -> dict:
    """Launch the fused sweep kernel for B state points.

    lnpi, op : f64[N]        composite surface and order parameter
    keys     : f64[S+1, N]   <N_i> rows then <U> (segment.key_row_addresses)
    volume   : f64[]         box volume
    a        : f64[B]        per-point reweight coefficient beta*(mu - mu0)

    Returns the ``mu_sweep_thermo`` dict (fe, mask, left, right, n_phases,
    valid, and with props n_i, x_i [B,P,S], ntot, u, density [B,P]).  Runs
    on ``torch.cuda.current_stream()`` and does not synchronise.
    """
    tensors = {"lnpi": lnpi, "op": op, "keys": keys, "volume": volume, "a": a}
    for name, t in tensors.items():
        if not t.is_cuda:
            raise ValueError(f"sweep_thermo: {name} is on {t.device}; the CUDA kernel needs CUDA tensors (engine='torch' runs the plain version)")
        if t.dtype != torch.float64:
            raise TypeError(f"sweep_thermo: {name} must be float64, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"sweep_thermo: {name} must be contiguous")
        if t.device != lnpi.device:
            raise ValueError(f"sweep_thermo: {name} is on {t.device}, lnpi on {lnpi.device}")
    if lnpi.dim() != 1 or op.shape != lnpi.shape or a.dim() != 1 or volume.numel() != 1:
        raise ValueError("sweep_thermo: need lnpi, op [N], a [B], scalar volume")
    N = lnpi.shape[0]
    S = keys.shape[0] - 1
    if keys.dim() != 2 or keys.shape[1] != N or S not in (1, 2):
        raise ValueError(f"sweep_thermo: keys must be [S+1, N] with nspec S in (1, 2), got {tuple(keys.shape)}")
    if not 1 <= max_phases <= MAX_PHASES:
        raise ValueError(f"sweep_thermo: max_phases={max_phases} outside the kernel's 1..{MAX_PHASES}")
    if smooth < 1:
        raise ValueError("smooth must be >= 1 to find relative extrema (scipy argrelextrema rejects order 0 too)")
    if N < 1 or N >= 2**31 - 1:
        raise ValueError(f"sweep_thermo: N={N} out of range")
    if collect not in (None, "janus"):
        raise NotImplementedError(f"sweep_thermo: the kernel implements collect None and 'janus', not {collect!r}")

    B, P, dev = a.shape[0], max_phases, lnpi.device
    f64 = dict(dtype=torch.float64, device=dev)
    out = {
        "fe": torch.empty((B, P), **f64),
        "mask": torch.empty((B, P), dtype=torch.bool, device=dev),
        "left": torch.empty((B, P), dtype=torch.int32, device=dev),
        "right": torch.empty((B, P), dtype=torch.int32, device=dev),
        "n_phases": torch.empty((B,), dtype=torch.int32, device=dev),
        "valid": torch.empty((B,), dtype=torch.bool, device=dev),
    }
    if props:
        out.update(
            n_i=torch.empty((B, P, S), **f64),
            x_i=torch.empty((B, P, S), **f64),
            ntot=torch.empty((B, P), **f64),
            u=torch.empty((B, P), **f64),
            density=torch.empty((B, P), **f64),
        )
    ptr = {k: v.data_ptr() for k, v in out.items()}
    lib = _lib()
    rc = lib.sweep_thermo_launch(
        dev.index if dev.index is not None else torch.cuda.current_device(),
        torch.cuda.current_stream(dev).cuda_stream,
        lnpi.data_ptr(),
        op.data_ptr(),
        keys.data_ptr(),
        volume.data_ptr(),
        a.data_ptr(),
        B,
        N,
        S,
        P,
        smooth,
        int(props),
        int(collect == "janus"),
        ptr["fe"],
        ptr["left"],
        ptr["right"],
        ptr["mask"],
        ptr["n_phases"],
        ptr["valid"],
        *(ptr.get(k) for k in ("n_i", "x_i", "ntot", "u", "density")),
    )
    if rc != 0:
        raise RuntimeError(f"sweep_thermo kernel launch failed: {lib.sweep_thermo_error_string(rc).decode()} ({rc})")
    sweep_thermo.launches += 1
    return out


sweep_thermo.launches = 0  # kernel launches this process; chip_smoke.py resets and reads it
