#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA GPU and check it.

    python3 chip_smoke.py

Phases (each raises on failure, so any failure exits non-zero):
  1. device: require a CUDA device (no CPU fallback); print the card's
     name and power limit as nvidia-smi reports them;
  2. build: compile the fused sweep kernel from csrc/ with nvcc;
  3. parity: the kernel against its plain PyTorch version on the card, on
     the three sweep cells and on randomized lnPI structures, props on/off,
     collect None/"janus": segmentation equal, floats within 1e-10 abs;
  4. main path: pipeline.mu_sweep_thermo(engine="auto") on the N=573 cell
     (B=524,288) and the N=31 cell (B=2,097,152) with the launch counter
     reset just before: every point valid, the sweep crosses from one
     phase to two, a sample of points agrees with the plain version; then
     kernel and plain version timed with CUDA events (warm, median of 3);
  5. the last line: {"ok": true, "device": {...}}.
Imports neither JAX nor the JAX package; composites come from
tests/torch_composites.py (numpy, seeded).
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

TOL = 1e-10  # the JAX package's kernel bar (tests/test_pallas_sweep.py)
SEG = ("valid", "mask", "n_phases", "left", "right")
PROPS = ("n_i", "x_i", "ntot", "u", "density")
MAIN_CELLS = ("n573", "n31")
REPLACES = "fhmcanalysis_tpu/core/pallas_sweep.py:758"  # _sweep_ds_pallas (pl.pallas_call at :773)


def log(*a):
    print(*a, flush=True)


def compare(got, want, props, where):
    """Kernel output against the plain version's: returns the worst abs
    difference per float field over valid masked slots."""
    import torch

    for k in SEG:
        if not torch.equal(got[k], want[k]):
            bad = (got[k] != want[k]).reshape(got[k].shape[0], -1).any(-1).nonzero()[:5, 0].tolist()
            raise AssertionError(f"{where}: segmentation field {k} differs at points {bad}")
    ok = want["mask"] & want["valid"][:, None]
    worst = {}
    for k in ("fe",) + (PROPS if props else ()):
        m = ok if got[k].dim() == 2 else ok[..., None]
        d = (torch.where(m, got[k], 0.0) - torch.where(m, want[k], 0.0)).abs()
        worst[k] = float(d.max()) if d.numel() else 0.0
        if not worst[k] <= TOL:
            raise AssertionError(f"{where}: {k} differs by {worst[k]:.3e} > {TOL}")
    return worst


def cuda_ms(fn, reps=3):
    """Median wall time of fn on the device, warm, with CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        torch.cuda.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def main():
    import torch

    # ---- 1. device ----
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this check runs only on a GPU")
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path[:0] = [root, os.path.join(root, "tests")]
    import numpy as np

    import torch_composites as TC
    from fhmcanalysis_torch import _build
    from fhmcanalysis_torch.core import cuda_sweep, pipeline, segment, state

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True, check=True, timeout=60
    ).stdout.strip().splitlines()[0]
    log(smi)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    name = torch.cuda.get_device_name(0)
    log(f"device: {name}; torch {torch.__version__} cuda {torch.version.cuda}")

    # ---- 2. build ----
    t0 = time.perf_counter()
    cuda_sweep._lib()
    info = _build.BUILD_INFO.get(cuda_sweep.NAME, {})
    log(f"build: {cuda_sweep.NAME} ready in {time.perf_counter() - t0:.1f} s (nvcc {info.get('seconds', 0.0):.1f} s)")
    for line in info.get("log", "").splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            log("  ptxas:", line.strip())

    def hist(d):
        return state.from_host(d, device=dev)

    def both(h, meta, mus, props, collect):
        got = pipeline.mu_sweep_thermo(h, meta, mus, props=props, collect=collect, engine="cuda")
        want = pipeline.mu_sweep_thermo(h, meta, mus, props=props, collect=collect, engine="torch")
        torch.cuda.synchronize()
        return got, want

    # ---- 3. kernel vs plain on the card ----
    worst: dict = {}

    def note(w):
        for k, v in w.items():
            worst[k] = max(worst.get(k, 0.0), v)

    for cname in TC.CELLS:
        d, mk, mus = TC.cell(cname, 4096)
        h, meta = hist(d), state.HistMeta(**mk)
        for props in (True, False):
            for collect in (None, "janus"):
                got, want = both(h, meta, mus, props, collect)
                note(compare(got, want, props, f"{cname} props={props} collect={collect}"))
    d31, mk31, _ = TC.cell("n31")
    for kind in TC.SURFACE_KINDS:
        rng = np.random.default_rng(TC.SURFACE_KINDS.index(kind))
        for smooth in (1, 2):
            for _ in range(4):
                h = hist(dict(d31, lnpi=TC.random_surface(kind, 31, rng)))
                meta = state.HistMeta(**dict(mk31, smooth=smooth, max_phases=8))
                note(compare(*both(h, meta, np.linspace(4.85, 5.15, 256), True, None), True, f"{kind} smooth={smooth}"))
    d14, mk14, _ = TC.cell("n1400")
    for i, y in enumerate(TC.janus_surfaces(1400)):
        got, want = both(hist(dict(d14, lnpi=10.0 * y)), state.HistMeta(**mk14), np.linspace(4.99, 5.01, 512), True, "janus")
        note(compare(got, want, True, f"janus surface {i}"))
    log("parity: kernel vs plain, worst abs diff on valid masked slots:", json.dumps({k: float(f"{v:.3e}") for k, v in worst.items()}))

    # ---- 4. main path ----
    runs = {}
    for cname in MAIN_CELLS:
        d, mk, mus_np = TC.cell(cname)
        h, meta = hist(d), state.HistMeta(**mk)
        mus = torch.as_tensor(mus_np, device=dev)
        cuda_sweep.sweep_thermo.launches = 0
        out = pipeline.mu_sweep_thermo(h, meta, mus, props=True)
        torch.cuda.synchronize()
        launches = cuda_sweep.sweep_thermo.launches
        B = mus.shape[0]
        if launches < 1:
            raise AssertionError(f"{cname}: the main path launched the kernel {launches} times")
        if out["fe"].shape != (B, meta.max_phases) or out["x_i"].shape != (B, meta.max_phases, meta.nspec):
            raise AssertionError(f"{cname}: unexpected output shapes")
        if not bool(out["valid"].all()):
            raise AssertionError(f"{cname}: {int((~out['valid']).sum())} points not valid")
        nph = torch.bincount(out["n_phases"].long(), minlength=3).tolist()
        if nph[1] == 0 or nph[2] == 0 or nph[1] + nph[2] != B:
            raise AssertionError(f"{cname}: phase counts {nph}: the sweep must cross from one phase to two")
        if not bool(torch.isfinite(out["fe"][out["mask"]]).all()):
            raise AssertionError(f"{cname}: non-finite free energy on a real phase")
        idx = torch.as_tensor(np.random.default_rng(0).choice(B, 4096, replace=False), device=dev)
        ref = pipeline.mu_sweep_thermo(h, meta, mus[idx], props=True, engine="torch")
        compare({k: v[idx] for k, v in out.items()}, ref, True, f"{cname} main path sample")

        a = pipeline._reweight_coeff(h, mus)
        keys = segment.key_rows(h.mom, meta).contiguous()
        k_ms = cuda_ms(lambda: cuda_sweep.sweep_thermo(h.lnpi, h.op, keys, h.volume, a, meta.smooth, meta.max_phases, True))
        torch.cuda.reset_peak_memory_stats()
        p_ms = cuda_ms(lambda: pipeline.mu_sweep_thermo(h, meta, mus, props=True, engine="torch"))
        peak = torch.cuda.max_memory_allocated() / 2**30
        e_ms = cuda_ms(lambda: pipeline.mu_sweep_thermo(h, meta, mus, props=True))
        runs[cname] = dict(B=B, N=h.nbins, launches=launches, kernel_ms=k_ms, plain_ms=p_ms, auto_ms=e_ms, phases=nph[1:3])
        log(
            f"main path {cname}: N={h.nbins} B={B} launches={launches} phases(1,2)={nph[1:3]} | "
            f"kernel {k_ms:.3f} ms = {B / k_ms * 1e3:.4g} points/s | mu_sweep_thermo auto {e_ms:.3f} ms = {B / e_ms * 1e3:.4g} points/s | "
            f"plain {p_ms:.3f} ms = {B / p_ms * 1e3:.4g} points/s (peak {peak:.2f} GiB) | {smi}"
        )

    head = runs[MAIN_CELLS[0]]
    kernels = [
        {
            "name": cuda_sweep.NAME,
            "route": "cuda",
            "source": "fhmcanalysis_torch/csrc/sweep_thermo.cu",
            "replaces": REPLACES,
            "launches": sum(r["launches"] for r in runs.values()),
            "max_abs_err": max(worst.values()),
            "ms": head["kernel_ms"],
            "plain_ms": head["plain_ms"],
            "cells": runs,
        }
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
