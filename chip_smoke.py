#!/usr/bin/env python3
"""Drive the PyTorch port's paths on one CUDA GPU and check them.

    python3 chip_smoke.py
    python3 chip_smoke.py --dump PATH      # save the main paths' outputs
    python3 chip_smoke.py --compare A B    # set two such dumps side by side

Phases (each raises on failure, so any failure exits non-zero):
  1. device: require a CUDA device (no CPU fallback); print the card's
     name and power limit as nvidia-smi reports them;
  2. build: compile every kernel from csrc/ with nvcc, one nvcc per
     source, all started together with the 2-D host flood
     (native/imaging.cpp, g++); print ptxas registers/stack/spills per
     kernel instantiation (each kernel is a template on G, the lanes per
     point or cell);
  3. parity: each kernel against its plain PyTorch version on the card:
     K1 (the mu sweep) on the three sweep cells and randomized lnPI
     structures, K2 (the (mu, beta, dMu) sweep) over its coverage (nspec
     1-2, orders 1-2, props on/off, collect None/"janus", used_ke,
     first_order_mom) at <=4,096 points per case, both at the G the rule
     picks and forced to every G the kernels build, and both on the
     shuffled mu grid (every warp mixes segmentation cases; a point count
     that leaves partial blocks and warps): segmentation equal, floats
     within 1e-10 abs; K2 at identity targets equal to K1 bit for bit at
     every G; K2's paired mode (one target per mu, the coexistence
     solver's) equal to the product mode's point (m, tix[m]) bit for bit
     at every G on n31 and n573 (orders 1-2, props on/off, collect
     None/"janus"), and to its plain version; K3 (the isopleth cell) over its coverage (orders 1-2,
     collect None/"janus", 2-3 sources, clamped rows, used_ke, max_phases
     4/8, N 31 and 1400, the fail-code surfaces, a narrow grid over five
     sources, a partial last block) at <=4,096 cells per case, at the G
     its rule picks and forced to every G: valid and fail_code equal,
     floats within 1e-10 abs on ok cells; the row former (K2's rows in
     one launch, cuda_mb.mb_rows) against pipeline._mb_rows bit for bit
     over orders 1-2, props, first_order_mom, used_ke and max_order 1-4 at
     N = 31, 573 and 1400 (the cells' composites and random moments),
     then at order 2 its device time, its call on the host's clock, the
     plain version's call and its bound;
  4. main paths, each with its launch counter read just before and again
     just after: pipeline.mu_sweep_thermo(engine="auto") on the N=573
     (B=524,288) and N=31 (B=2,097,152) cells;
     pipeline.mu_beta_sweep_thermo(engine="auto") on mb31 at orders 1 and
     2 (65,536 mu x 64 targets = 4,194,304 points): phases cross from one
     to two, a sample agrees with the plain version; and
     binary.isopleth.isopleth(...).make_grid(engine="auto") on iso31 at
     orders 1 and 2 (301 dMu_2 x 834 mu_1 = 251,034 cells) and on iso1400
     (128 x 128 cells at N=1400): most cells valid, one- and two-phase
     surfaces, a sample agrees with the plain version.  The sweep's and
     make_grid's runs also read the row former's counter: one launch a
     sweep, one a source of the grid.  Kernel, plain
     version and "auto" (and make_grid) timed with CUDA events (warm,
     median of 3);
  5. layouts: K1's time at G = 1 and G = 32 across N = 31, 63, 127, 255,
     573, 1400 (smooth 1) and on the n573 (smooth 10) and n1400 (smooth
     2) cells, each at half and twice the point count where
     cuda_sweep.lanes_per_point switches layout and at 262,144 points (the
     n1400 cell also at its own 4,096), K2's on n31 at half and twice
     that count and on mb31 at both orders, and K3's on the iso31 sources
     (orders 1 and 2) and the iso1400 ones at half and twice the cell
     count where cuda_iso.lanes_per_cell switches (cuda_iso.g1_switch)
     and at the main-path grid -- the measurement behind the rules; then one torch.profiler
     window over three mb31_o2 "auto" calls:
     K2's share of device time and the idle share of the window;
  5b. coexistence, each path with its launch counter read just before
     and again just after: solve.trace_coexistence(engine="auto") on coex573
     (256 betas on the n573 composite, K2's paired mode) and
     solve.find_phase_eq_state over 256 mu guesses on n31 (K1): every beta
     converged to |dF.E./kT| <= lnZ_tol with two phases, the row former
     launched at least once, the same
     convergence and mu_star within 1e-9 as engine="torch", the properties
     at mu_star within 1e-10 of the plain version's; solves/s for "auto" and
     "torch" (CUDA events, warm, median of 3), K2 launches and Nelder-Mead
     steps per trace, the trace at sync intervals 1-32, one solver step's
     K2 launch against its plain version, its bound and the product-diagonal
     alternative (K2 at M = A = 5 x 256), a layout line at that step, and a
     utils.profiling window over one trace (K2's share of device time, the
     idle share; the timeline goes to _profiles/coex573/trace.json);
  5c. the 2-D surface path (core.segment2d under two_dim; plain PyTorch
     but for the boundary integrals' kernel, csrc/boundary2d.cu, and the
     watershed's, csrc/watershed2d.cu):
     pore_state_sweep on pore13 (13 x 21) and
     pore96 (96 x 385), joint_state_sweep on joint96 (96 x 385), at S = 64
     and, on the 96 x 385 cells, S = 1,024: the device engine equal to the
     host flood on every tie-free unsaturated state (and on 64 of the
     1,024), both within 1e-10 of pore_hist(engine="numpy") on 4 states a
     cell, the class on the card on one; states/s of both engines and of
     joint96 with its surfaces, peak memory, pore96's stage times at S =
     1, 64 and 1,024 and joint96's at 64 and 1,024 (the boundary integrals
     alone: the kernel by CUDA events and by its device time, its bound
     and the plain one-hot on the card; the watershed's kernel the same
     way, its six outputs equal to the plain function's on the card), and a
     utils.profiling window over one S = 1,024 call (timeline to
     _profiles/joint96/trace.json); an exact tie with and without
     tie_fallback, and saturated slots; a {"two_dim": ...} line;
  5d. window patching (win_patch, host numpy over the native table reader
     native/fast_table.cpp, g++; no kernel of its own) on win800: 20
     FHMCSimulation windows (ntot_window_scaling(800, 25, 20, 5), 5-bin
     overlaps) cut from a two-species N_tot 0-800 composite, each lnPI
     shifted by a seeded constant, written by tests/torch_windows.py as
     final_* files and as checkpoint-named ones (two or three per window)
     -> get_patch_sequence -> test_nebr_equil(trust=True) -> the steps
     of fhmc_patch._drive_patch in memory (no h5py here) at offset 1,
     smooth False and True -> histogram.from_composite(device=card) ->
     pipeline.mu_sweep_thermo(engine="auto") on the n573-sized mu grid,
     K1's launch counter read just before and again just after: the native
     parser equal to numpy's on every table, both trees patched alike, lnPI
     within 1e-10 and moments within 1e-12 relative of the source, K1 on
     the patched composite equal in segmentation and within 1e-10 to K1 on
     the source and to the plain version on a sample; host times (warm,
     median of 3) and the host CPU model in a {"win_patch": ...} line;
  5e. parallel/ over grid_mesh() (the machine's cards) and over four
     shards of card 0 (grid_mesh(4, devices=[card] * 4)), each route with
     its launch counter read just before it and again just after:
     shard_map_mu_sweep on n573 (K1), sharded_mu_beta_sweep on mb31 at
     order 1 (K2), sharded_trace_coexistence on coex573 (K2's paired
     mode), sharded_make_grid on iso31_o1 (834 mu_1 in uneven blocks) and
     iso1400_o1 (K3), sharded_pore_state_sweep / sharded_joint_state_sweep
     on pore96 and joint96 at S = 1,024, and surface.py on the n1400
     composite's lnPI (smooth 2 and 60) and on pore96's surface: one
     launch a shard (the trace: three or more a shard), the thread's
     current device unchanged by each call, outputs equal to the one-device
     call's (floats bit for bit where every shard ran its G, else within
     1e-10; the normalizations within 1e-12); the G of each shard, sharded
     and one-device times (CUDA events, warm, median of 3), and a
     {"parallel": ...} line;
  5f. capacity: the kernels' wide builds (64 phase slots, and K1's 6
     per-phase sums for nspec 3-4; cuda_sweep.capacity / accumulators pick
     them) through the entry points, each launch counter read just
     before the path and again just after, each against its plain version
     on the card (segmentation, ok and fail_code equal; floats within
     1e-10): mu_sweep_thermo on multi573 (N=573, a rippled surface with
     11-25 maxima) over 524,288 mu at 8 (every point overflows), 16, 32 and
     64 slots, and on tern573 / quat573 (three and four species) at 4 slots
     with and without janus; mu_beta_sweep_thermo on multi573 over 4,096
     mu x 64 targets at orders 1-2 and 16 and 64 slots;
     find_phase_eq_state over 256 betas at 16 slots (K2's paired mode);
     make_grid on overflow31 (the fail-code test's ten-peak sources,
     301 x 834 cells) and on overflow1400 (the iso1400 sources with
     torch_composites.ripple1400, 10-20 maxima, 128 x 128 cells at N =
     1400) at 8 slots (fail code 3 everywhere) and, with the sources'
     _meta raised, at 16 and 64 (overflow31: every cell ok; overflow1400:
     some cells ok at 16, most at 64), the bare K3 wrapper at 16
     and 64 forced to G = 1 and 32 against the plain version, and the
     x_m area K3's library reserves; kernel ms (median
     of 3), plain ms (one run), make_grid ms, launches, bound, peak GiB,
     and layout lines of K1, K2 and K3 at 16 and 64 slots (K3 at N = 31
     and 1400); each wide build's ptxas registers, stack, spill stores and
     static shared bytes beside its library's count (<name>_static_smem:
     the index slots, and K1's and K2's row tile or K3's staged-source
     list; phase 2 holds every build's shared bytes to it), K3's with its
     dynamic x_m area; a
     {"capacity": ...} line;
  5g. the reference-notebook workflows of examples/torch_*.py, each run on
     the card with in-memory inputs (tests/torch_windows.example_inputs:
     the square-well trees patched in memory, the n31 fixture, the binary
     ideal gas in closed form) with the launch counters read just
     before and again just after: the phase diagram (K2's paired mode), the
     binary isopleth, combining simulations and mutual diffusion (K3), the
     multivariable extrapolation and the square-well notebook (the class
     path, no kernel); each against engine="torch" on the card (or, with
     no kernel, its run on the CPU): segmentation, validity and fail codes
     equal, floats within 1e-10 relative (the Gibbs-Duhem isobars within
     1e-8), mu* within 1e-9; each script's acceptance checks, where the
     in-repo data can meet them; find_phase_eq_state(extrapolate=True)
     over 256 betas on coex573 and coex31 at 16 slots: its states, built
     in one pass, against the per-target loop (within 1e-12; bit-identical
     or not), the host-clock times of the solve, of the states in one
     pass and of the loop, and thermo + phase_props of the batch;
     combining_simulations at a production lattice (401 mu_1 x 501 dMu_2,
     N = 401, order 2) against the ideal gas's closed form, K3 alone
     there against its plain version with its time and bound; a
     {"workflows": ...} line;
  6. a {"kernels": [...]} line with each kernel's launches, worst error,
     times and bound (the row former last, replacing no TPU kernel, its
     launches those of the main paths of phases 4 and 5b; the 2-D
     boundary integrals after it, their times those of pore96 at S = 1,
     64 and 1,024, their launches phase 5c's; window patching adds none; the
     sharded routes add cells "<cell> mesh cards" / "<cell> mesh x4"
     with their launches, phase 5f its capacity cells, phase 5g its
     workflow cells), then the last
     line: {"ok": true, "device": {...}}.

--dump PATH runs only phases 1-2 and the main paths of K1, K2 and K3 (a
strided sample of the sweeps' points, every isopleth cell), K3's parity
cases and the wide builds' cases (wide_cases: K1 on multi573 at 16, 32
and 64 slots, None and janus; K2 on multi573 at 16 and 64, orders 1-2;
K2's paired coex31 step at 16; K3 on overflow31 at 16 at the rule's G and
G = 32 and at 64 at each G, and on overflow1400 at 16 and 64 at each G;
K1 and K2 on ten31 and ripple121 at 16 and 64 forced to each G;
4,096 sampled points each, and each case's kernel ms, and K3's on its
main-path grids: the median of 3 reps of 10 launches each),
through entry points every tree of the port has had since the wide
builds, and saves the kernels' outputs, K3's also forced to G = 32
(" G=32" keys); run it from a copy of this file, with
tests/torch_composites.py, placed in another tree to dump that tree's
kernels.  --compare A B prints, per output, whether segmentation is
equal, whether every field is bit-identical, and the worst float
difference, then each wide case's kernel ms from A beside B's.
Imports neither JAX nor the JAX package; composites come from
tests/torch_composites.py (numpy, seeded).
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import re
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
TOL = 1e-10  # the JAX package's kernel bar (tests/test_pallas_sweep.py)
SEG = ("valid", "mask", "n_phases", "left", "right")
PROPS = ("n_i", "x_i", "ntot", "u", "density")
MAIN_CELLS = ("n573", "n31")
MB_ORDERS = (1, 2)  # main-path cells mb31_o1, mb31_o2
ISO_CELLS = (("iso31_o1", "ISO31", 1), ("iso31_o2", "ISO31", 2), ("iso1400_o1", "ISO1400", 1))
LAYOUT_NS = (31, 63, 127, 255, 573, 1400)  # K1's layout timing, smooth 1, plus the n573 and n1400 cells
LAYOUT_POINTS = 262_144
DUMP_POINTS = 131_072  # per sweep cell in --dump
WIDE_DUMP_POINTS = 4096  # per wide-build case in --dump
WIDE_TIMED_LAUNCHES = 10  # --dump times a wide case's kernel over this many launches a rep
CAP_MB = (4096, 64)  # phase 5f: K2's mu values x targets on multi573
WIDE_PER_SM = (4, 8, 16, 32, 64, 128, 256, 384)  # phase 5f: points per SM of the wide builds' layout lines
WIDE_PER_SM_1400 = (4, 16, 64, 256, 512, 1024, 2048)  # phase 5f: cells per SM of K3's wide layout lines at N = 1400 (its switch: 1,024)
REPLACES = {
    "sweep_thermo": "fhmcanalysis_tpu/core/pallas_sweep.py:758",  # _sweep_ds_pallas (pl.pallas_call at :773)
    "mb_sweep_thermo": "fhmcanalysis_tpu/core/pallas_mb.py:482",  # _mb_ds_pallas (pl.pallas_call at :496)
    "iso_grid": "fhmcanalysis_tpu/core/pallas_iso.py:563",  # _iso_ds_pallas (-> _launch :532, pl.pallas_call at :539)
}
CUTOFF = 10.0  # the isopleth class's is_safe / edge cutoff
# The least time of the card for a kernel's work: the larger of its bytes
# (each input read once, each output written once) over HBM3's 3.35 TB/s
# and its f64 operations over the FP64 vector peak, 34 TFLOP/s (H100 SXM
# data sheet, 700 W).  A f64 exp counts as EXP_OPS operations: CUDA's
# double exp is a range reduction, a degree-11 polynomial in fused
# multiply-adds (2 operations each) and a scaling, about 26 in all.
HBM_BYTES_PER_S = 3.35e12
FP64_OPS_PER_S = 34e12
EXP_OPS = 26


def launch_count(kernel):
    """Launches of kernel "k1", "k2", "k3", "mb_rows" (the row former) or
    "b2d" (the 2-D boundary integrals), or "k2_xarea" (K2's that formed x'
    into its area) or "k2_tile" (those that also formed their targets'
    key' once, in the target tile), this process so far (the program's
    counters)."""
    from fhmcanalysis_torch.utils import profiling

    return profiling.counters().get(f"launches.{kernel}", 0)


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
        g, w = torch.where(m, got[k], 0.0), torch.where(m, want[k], 0.0)
        d = torch.where(g == w, 0.0, (g - w).abs())  # fe is +inf on a real phase with no mass
        worst[k] = float(d.max()) if d.numel() else 0.0
        if not worst[k] <= TOL:
            at = int(d.reshape(d.shape[0], -1).amax(-1).argmax())
            raise AssertionError(f"{where}: {k} differs by {worst[k]:.3e} > {TOL} (worst at point {at})")
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


def device_ms(fn, kernel, reps=20):
    """Mean device time of the launches of `kernel` (a substring of its
    name) over reps calls of fn, from a torch.profiler window: for a launch
    shorter than the host's call, CUDA events around the call time the
    host.  None where the profiler recorded no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    d = [e.time_range.end - e.time_range.start for e in prof.events() if e.device_type.name == "CUDA" and kernel in e.name]
    return sum(d) / len(d) / 1e3 if d else None


def bound(inputs, outputs, ops):
    """(bound_ms, bound_by) for a kernel call: bytes of every input and
    output tensor once over the memory rate, against ops over the f64 peak."""
    nbytes = sum(t.numel() * t.element_size() for t in list(inputs) + list(outputs) if t is not None)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP64_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def covered_bins(out, N=None):
    """Bins summed by the tail over all points and phases of this run: the
    per-phase max, exp and sums run over [left, right) of each real phase,
    both clamped to [0, N] where N is given (the plain segmentation's
    bounds of a point that overflows its slots may read BIG)."""
    left, right = out["left"], out["right"]
    if N is not None:
        left, right = left.clamp(0, N), right.clamp(0, N)
    return int(((right - left).clamp(min=0) * out["mask"]).sum())


def tail_ops(out, B, N, smooth, x_ops, key_ops):
    """f64 operations the tail needs for this run's data: x once per bin
    (x_ops) and the 4*smooth stencil compares per bin and point; per
    covered bin the phase max, the shift, one exp, the weight sum and the
    key rows (key_ops: forming each key row and its multiply-add).  The
    segmentation's integer logic (O(P^2) per point) is not counted."""
    return B * N * (x_ops + 4 * smooth) + covered_bins(out, N) * (3 + EXP_OPS + key_ops)


def compare_iso(got, want, where, min_ok=0.0):
    """K3's (z, density, fe, ok, fail_code) against the plain version's:
    ok and fail_code equal, floats within TOL on ok cells; returns the
    worst abs difference per float field."""
    import torch

    for k, name in ((3, "ok"), (4, "fail_code")):
        if not torch.equal(got[k], want[k]):
            bad = (got[k] != want[k]).nonzero()[:5].tolist()
            raise AssertionError(f"{where}: {name} differs at cells {bad}")
    ok = want[3]
    if float(ok.double().mean()) < min_ok:
        raise AssertionError(f"{where}: only {float(ok.double().mean()):.3f} of the cells are valid; the comparison would be vacuous")
    worst = {}
    for k, name in ((0, "z"), (1, "density"), (2, "fe")):
        d = (got[k] - want[k]).abs()[ok]
        worst[name] = float(d.max()) if d.numel() else 0.0
        if not worst[name] <= TOL:
            raise AssertionError(f"{where}: {name} differs by {worst[name]:.3e} > {TOL}")
    return worst


def ptxas_report(text):
    """[(kernel, G or None, capacity or None, sums or None, registers, stack
    bytes, spill store bytes, static shared bytes)] from nvcc
    --ptxas-options=-v output: G, the phase-slot capacity and (K1) the
    per-phase sums from the kernel's template arguments, and " paired" after
    the name of K2's paired-mode instantiation, " xa" after K2's with the x'
    area, " tile" after K2's with the target tile, " xm" after K3's with the
    x_m area.  A tree from before the
    capacities has G only (capacity None)."""
    rows, fn, stack, spill = [], None, 0, 0
    for line in text.splitlines():
        if m := re.search(r"Function properties for (\S+)", line):
            fn = m.group(1)
        elif m := re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores", line):
            stack, spill = int(m.group(1)), int(m.group(2))
        elif (m := re.search(r"Used (\d+) registers", line)) and fn:
            kname = re.search(r"\d+([a-z_]+_kernel)", fn)
            targs = re.search(r"_kernelI((?:L[ib]\d+E)+)E", fn)
            args = re.findall(r"L([ib])(\d+)E", targs.group(1)) if targs else []
            ints = [int(v) for t, v in args if t == "i"]
            flags = [v == "1" for t, v in args if t == "b"]
            name = kname.group(1) if kname else fn
            if name.startswith("iso_grid"):
                name += " xm" if any(flags) else ""
            else:
                name += (" paired" if flags and flags[0] else "") + (" xa" if len(flags) > 1 and flags[1] else "") + (" tile" if len(flags) > 2 and flags[2] else "")
            smem = re.search(r"(\d+) bytes smem", line)
            rows.append((name, ints[0] if ints else None, ints[1] if len(ints) > 1 else None, ints[2] if len(ints) > 2 else None,
                         int(m.group(1)), stack, spill, int(smem.group(1)) if smem else 0))
            fn = None
    return rows


class Ctx:
    """What every phase uses: torch, numpy, the composites, the port's
    modules, the card."""

    def __init__(self):
        import torch

        if not torch.cuda.is_available():
            raise SystemExit("chip_smoke: no CUDA device; this check runs only on a GPU")
        sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]
        import numpy as np

        import torch_composites as TC
        from fhmcanalysis_torch import _build
        from fhmcanalysis_torch.binary import isopleth as iso_cls
        from fhmcanalysis_torch.core import cuda_iso, cuda_mb, cuda_sweep, pipeline, segment, state

        try:
            from fhmcanalysis_torch.core import launch
        except ImportError:  # a tree from before the launch module (--dump run from an older tree) kept its facts in cuda_sweep
            launch = cuda_sweep
        try:
            from fhmcanalysis_torch.core import cuda_b2d
        except ImportError:  # a tree from before the boundary integrals' kernel: its 2-D path is plain
            cuda_b2d = None
        try:
            from fhmcanalysis_torch.core import cuda_ws2d
        except ImportError:  # a tree from before the watershed's kernel: its watershed is plain
            cuda_ws2d = None
        self.cuda_b2d, self.cuda_ws2d = cuda_b2d, cuda_ws2d
        self.torch, self.np, self.TC, self._build, self.launch = torch, np, TC, _build, launch
        self.iso_cls, self.IB = iso_cls, sys.modules["fhmcanalysis_torch.binary.isopleth"]
        self.cuda_iso, self.cuda_mb, self.cuda_sweep = cuda_iso, cuda_mb, cuda_sweep
        self.pipeline, self.segment, self.state = pipeline, segment, state
        self.smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True, check=True, timeout=60
        ).stdout.strip().splitlines()[0]
        log(self.smi)
        self.dev = torch.device("cuda", 0)
        torch.cuda.set_device(self.dev)
        self.name = torch.cuda.get_device_name(0)
        log(f"device: {self.name}; torch {torch.__version__} cuda {torch.version.cuda}")

    def build(self):
        """Phase 2: one nvcc per source, started together."""
        try:
            from fhmcanalysis_torch import native
        except ImportError:  # a tree from before the 2-D path (--dump run from an older tree)
            native = None

        libs = (self.cuda_sweep, self.cuda_mb, self.cuda_iso) + tuple(m for m in (self.cuda_b2d, self.cuda_ws2d) if m is not None)
        t0 = time.perf_counter()
        with ThreadPoolExecutor(len(libs) + 2) as pool:
            flood = pool.submit(lambda: native is not None and native.IMAGING_AVAILABLE)  # the 2-D host flood, g++
            table = pool.submit(lambda: getattr(native, "NATIVE_AVAILABLE", False))  # win_patch's table reader, g++
            list(pool.map(lambda mod: mod._lib(), libs))
            flood, table = flood.result(), table.result()
        log(f"build: {', '.join(mod.NAME for mod in libs)} ready in {time.perf_counter() - t0:.1f} s; native flood (native/imaging.cpp, g++) {'built' if flood else 'not built'}; "
            f"native table reader (native/fast_table.cpp, g++) {'built' if table else 'not built'}")
        from fhmcanalysis_torch.utils import profiling

        n = getattr(profiling, "counters", dict)()  # a tree from before the counters (--dump run from an older tree) has none
        log(f"  kernel libraries: {n.get('kernel.builds', 0)} built in {n.get('kernel.build_s', 0.0):.1f} s of nvcc (summed over the parallel builds), "
            f"{n.get('kernel.loads', 0)} loaded and checked in {n.get('kernel.load_s', 0.0):.3f} s")
        report = {}
        for mod in libs:
            info = self._build.BUILD_INFO.get(mod.NAME, {})
            rows = ptxas_report(info.get("log", ""))
            report[mod.NAME] = [dict(kernel=k, lanes=g, capacity=c, sums=a, registers=r, stack=st, spill_stores=sp, smem=sm) for k, g, c, a, r, st, sp, sm in rows]
            for k, g, c, a, r, st, sp, sm in rows:
                log(f"  ptxas: {k}" + (f" G={g}" if g else "") + (f" cap={c}" if c else "") + (f" sums={a}" if a else "") +
                    f": {r} registers, {st} bytes stack, {sp} bytes spill stores, {sm} bytes smem")
                want = self.shared_bytes(mod, g, c, k) if c is not None else None
                if want is not None and sm != want:
                    # the block's static shared memory is its index slots, and K3's staged-source list or K1's and K2's row tile
                    raise AssertionError(f"ptxas: {k} G={g} cap={c} reserves {sm} bytes of static shared memory; its library counts {want}")
        return report

    def shared_bytes(self, mod, G, cap, kernel=""):
        """The static shared bytes mod's library counts for a block of its
        kernel (<name>_static_smem): K3 its index slots and staged-source
        list (G < 32), K1 and K2 their index slots and row tile, K2's builds
        with the x' area (tiled or not) those of their own smaller block;
        None for a library without the count (a tree from before it)."""
        lib = mod._lib()
        if not hasattr(lib, f"{mod.NAME}_static_smem"):
            return None
        if mod is self.cuda_mb:
            return lib.mb_sweep_thermo_static_smem(G, cap, int(" xa" in kernel))
        return getattr(lib, f"{mod.NAME}_static_smem")(G, cap)

    def k3_layout(self, rule, G, W, NX, NY, N, order, max_phases=8):
        """K3's "staged_sources" or "xm_bytes" for a grid of W sources, NX x
        NY cells and N bins, as its library decides them."""
        cm = self.cuda_mb
        return getattr(self.cuda_iso._lib(), f"iso_grid_{rule}")(G, self.launch.capacity(max_phases), W, NX, NY, N, cm.n_xrows(2, order), cm.n_groups(2, order, False))

    def hist(self, d):
        return self.state.from_host(d, device=self.dev)

    def iso_setup(self, name, order, beta, mu1_v, dmu2_v, dmu2s=None, used_ke=False, lnpi=None, smooth=None):
        TC = self.TC
        ds, mk = TC.iso_sources(name, TC.ISO_DMU2 if dmu2s is None else dmu2s, 3, used_ke, lnpi, smooth)
        iso = self.iso_cls([TC.port_histogram(d, mk, device=self.dev) for d in ds], beta, order=order)
        lr, wts = iso._bracket(dmu2_v, 2.5)
        return iso, [h._hist() for h in iso.data["histograms"]], mk, lr, wts

    def iso_args(self, name="n31", order=1, collect=None, beta=1.02, NX=64, NY=64, dmu2=(-5.3, -3.7), max_phases=8, mu1=None, **kw):
        """The iso_grid arguments of one K3 parity case; kw go to iso_sources."""
        np = self.np
        mu1_v = np.linspace(*(mu1 or self.TC.mu_window(**self.TC.CELLS[name])), NX)
        dmu2_v = np.linspace(*dmu2, NY)
        iso, srcs, mk, lr, wts = self.iso_setup(name, order, beta, mu1_v, dmu2_v, **kw)
        metas = [self.state.HistMeta(**dict(mk, max_phases=max_phases))] * len(srcs)
        return (srcs, metas, mu1_v, dmu2_v, lr, wts, beta, order, CUTOFF, collect)

    def overflow_inputs(self, name):
        """(source dicts, meta kwargs, mu1_v, dmu2_v, beta) of a K3 capacity
        cell: overflow31 (the fail-code test's ten-peak sources on iso31's
        301 x 834 cells over that test's window) or overflow1400 (the
        iso1400 sources with ripple1400 on ISO1400's 128 x 128 cells)."""
        np, TC = self.np, self.TC
        if name == "overflow31":
            ds, mk = TC.iso_sources("n31", lnpi=TC.ten_peak())
            return ds, mk, np.linspace(4.9, 5.1, TC.ISO31["NX"]), np.linspace(-4.9, -4.1, TC.ISO31["NY"]), 1.001
        g = TC.ISO1400
        ds, mk = TC.iso_sources(g["name"], lnpi=TC.ripple1400())
        mu1, dmu2, _ = TC.iso_grid_args(g)
        return ds, mk, np.linspace(*mu1, g["NX"]), np.linspace(*dmu2, g["NY"]), g["beta"]

    def overflow_sources(self, name):
        """(srcs, meta kwargs, mu1_v, dmu2_v, lr, wts, beta) of a K3 capacity
        cell on the card (overflow_inputs)."""
        ds, mk, mu1_v, dmu2_v, beta = self.overflow_inputs(name)
        iso = self.iso_cls([self.TC.port_histogram(d, mk, device=self.dev) for d in ds], beta, order=1)
        lr, wts = iso._bracket(dmu2_v, 2.5)
        return [h._hist() for h in iso.data["histograms"]], mk, mu1_v, dmu2_v, lr, wts, beta

    def iso_main(self, gname, order):
        """(iso, grid, srcs, mk, lr, wts, mu1_v, dmu2_v) of an isopleth main-path cell."""
        np, TC = self.np, self.TC
        g = getattr(TC, gname)
        grid = TC.iso_grid_args(g)
        mu1_v, dmu2_v = np.linspace(*grid[0], g["NX"]), np.linspace(*grid[1], g["NY"])
        iso, srcs, mk, lr, wts = self.iso_setup(g["name"], order, g["beta"], mu1_v, dmu2_v)
        return g, iso, grid, srcs, mk, lr, wts, mu1_v, dmu2_v


def k3_cases(np, TC):
    """K3's parity cases: dMu_2 rows reach past the sources on both sides,
    so the end rows are clamped to one source (L == R, weights [1, 1])."""
    x31 = np.linspace(0.0, 1.0, 31)
    three_peak = 11.5 * np.exp(-((x31 - 0.15) ** 2) / 0.004) + 11.3 * np.exp(-((x31 - 0.45) ** 2) / 0.003) + 12 * np.exp(-((x31 - 0.8) ** 2) / 0.006)
    ten_peak = 5.0 * np.sin(2 * np.pi * np.arange(31) / 3.1) - 0.01 * np.arange(31)
    ten_peak[-1] = ten_peak.min() - 50.0
    walk = np.cumsum(np.random.default_rng(7).standard_normal(31)) * 2.0
    walk[-1] = walk.min() - 50.0
    near5 = dict(beta=1.001, mu1=(4.9, 5.1), dmu2=(-4.9, -4.1))  # the fail-code tests' window
    cases = [dict(order=o, collect=c, max_phases=p) for o in (1, 2) for c in (None, "janus") for p in (4, 8)]
    for o in (1, 2):
        cases += [
            dict(order=o, dmu2s=(-5.0, -4.6, -4.2)),
            dict(order=o, used_ke=True),
            dict(order=o, collect="janus", lnpi=three_peak, **near5),
            dict(name="n1400", order=o, beta=1.0, NX=64, NY=16),
        ]
    for lnpi, smooth in ((0.1 * np.arange(31.0), None), (ten_peak, None), (walk, 4)):  # codes 1, 3, 2
        cases.append(dict(order=1, lnpi=lnpi, smooth=smooth, min_ok=0.0, **near5))
    # the shape grids: five sources on 12 columns, and a partial last block
    for g, dmu2s in ((TC.ISO_NARROW, TC.ISO_FIVE_DMU2), (TC.ISO_PARTIAL, TC.ISO_DMU2)):
        for o in (1, 2):
            cases.append(dict(name=g["name"], order=o, beta=g["beta"], NX=g["NX"], NY=g["NY"], dmu2=g["dmu2"], dmu2s=dmu2s))
    return cases


def wide_cases(C):
    """The wide builds' --dump cases: [(key, run, kernel)], run() the
    outputs through the entry point (a dict of tensors with one leading
    point axis), kernel() the wrapper's launch alone (timed).  K1 on
    multi573 (524,288 mu) at 16, 32 and 64 slots, None and janus; K2 on
    multi573 (4,096 mu x 64 targets) at 16 and 64 slots, orders 1-2; K2's
    paired step on coex31 at 16 (1,280 points, as find_phase_eq_state
    launches it); K3 on overflow31 (301 x 834 cells) at 16, at the rule's
    G and at G = 32, and at 64 at each G, and on overflow1400 (128 x 128
    cells at N = 1400) at 16 and 64 at each G; and K1 and K2 (order 1) on
    ten31 and ripple121 at 16 and 64 slots at 64 points per SM, forced to
    G = 1 and to G = 32."""
    torch, np, TC, pipeline, segment, state, IB = C.torch, C.np, C.TC, C.pipeline, C.segment, C.state, C.IB
    cuda_sweep, cuda_mb, cuda_iso, dev = C.cuda_sweep, C.cuda_mb, C.cuda_iso, C.dev
    from fhmcanalysis_torch.core import solve as SV

    n_sm = cuda_sweep.sm_count(dev.index)
    flat = lambda o: {k: v.reshape((-1,) + v.shape[2:]) for k, v in o.items()}  # noqa: E731
    cases = []

    def k1(name, P, collect, B=None, G=None):
        d, mk, mus_np = TC.capacity_cell(name, B, max_phases=P)
        h, meta = C.hist(d), state.HistMeta(**mk)
        mus = torch.as_tensor(mus_np, device=dev)
        a = pipeline._reweight_coeff(h, mus)
        keys = segment.key_rows(h.mom, meta).contiguous()
        run = lambda: pipeline.mu_sweep_thermo(h, meta, mus, props=True, collect=collect, engine="cuda", _lanes=G)  # noqa: E731
        kern = lambda: cuda_sweep.sweep_thermo(h.lnpi, h.op, keys, h.volume, a, meta.smooth, P, True, collect, _lanes=G)  # noqa: E731
        return run, kern

    def k2(name, P, order, M, A, G=None):
        d, mk, mus_np = TC.capacity_cell(name, M, max_order=3, max_phases=P)
        h, meta = C.hist(d), state.HistMeta(**mk)
        mus = torch.as_tensor(mus_np, device=dev)
        betas = d["curr_beta"] * np.linspace(0.98, 1.02, A)
        dmus = (d["curr_mu"][1:] - d["curr_mu"][0]) + np.linspace(-0.5, 0.5, A)[:, None]
        mu_t, a, xrows, krows, tg = pipeline._mb_inputs(h, meta, mus, betas, dmus, order, True, False)
        run = lambda: flat(pipeline.mu_beta_sweep_thermo(h, meta, mus, betas, dmus, order=order, props=True, engine="cuda", _lanes=G))  # noqa: E731
        kern = lambda: cuda_mb.mb_sweep_thermo(h.lnpi, h.op, xrows, krows, h.volume, mu_t, a, tg, meta.nspec, meta.smooth, P, order, True, _lanes=G)  # noqa: E731
        return run, kern

    for P in (16, 32, 64):
        for collect in (None, "janus"):
            cases.append((f"K1 multi573 P={P}" + (" janus" if collect else ""), *k1("multi573", P, collect)))
    M, A = CAP_MB
    for P in (16, 64):
        for order in (1, 2):
            cases.append((f"K2 multi573 P={P} o{order}", *k2("multi573", P, order, M, A)))
    # K2's paired step at 16 slots, as find_phase_eq_state launches it
    d, mk, _, kw = TC.coex31_guesses()
    h, meta = C.hist(d), state.HistMeta(**dict(mk, max_phases=16))
    betas = np.linspace(0.98, 1.02, 256)
    dmu = h.curr_mu[1:] - h.curr_mu[0]
    obj = SV._Objective(h, meta, torch.as_tensor(betas, device=dev), dmu[None].expand(256, -1), 1, kw["min_width"], True, None, "cuda")
    step_mu = torch.linspace(5.5, 5.7, 1280, device=dev, dtype=torch.float64)
    step_tix = torch.arange(256, dtype=torch.int32, device=dev).repeat(5)
    step_a = pipeline._reweight_coeff(h, step_mu).contiguous()
    paired = lambda: cuda_mb.mb_sweep_thermo(h.lnpi, h.op, obj.xrows, None, h.volume, step_mu, step_a, obj.tg, meta.nspec, meta.smooth, 16, 1, False, tix=step_tix)  # noqa: E731
    cases.append(("K2 coex31 P=16 paired step", paired, paired))
    # K3 on overflow31 (301 x 834 cells) at 16 slots at the rule's G and
    # at 64 at each G, and on overflow1400 (128 x 128) at 16 and 64 at each G
    names = ("z", "density", "fe", "ok", "fail_code")
    for name, P, lanes in (("overflow31", 16, (None, 32)), ("overflow31", 64, (1, 32)), ("overflow1400", 16, (1, 32)), ("overflow1400", 64, (1, 32))):
        srcs, mk3, mu1_v, dmu2_v, lr, wts, beta = C.overflow_sources(name)
        metas = [state.HistMeta(**dict(mk3, max_phases=P))] * len(srcs)
        pro = IB._iso_prologue(srcs, metas[0], mu1_v, dmu2_v, lr, wts, beta, 1, CUTOFF)
        kin = [pro[k] for k in ("lnpi", "op", "xrows", "krows", "a", "edge", "mu", "lr", "wts", "tg", "volume")]
        for G in lanes:
            run = lambda G=G, a=(srcs, metas, mu1_v, dmu2_v, lr, wts, beta): dict(zip(names, (t.reshape(-1) for t in IB.iso_grid(*a, 1, CUTOFF, engine="cuda", _lanes=G))))  # noqa: E731
            kern = lambda G=G, kin=kin, sm=mk3["smooth"], P=P: cuda_iso.iso_grid(*kin, sm, P, 1, CUTOFF, _lanes=G)  # noqa: E731
            cases.append((f"K3 {name} P={P}" + (f" G={G}" if G else ""), run, kern))
    # ten31 and ripple121 at 64 points per SM, each layout forced
    for name in ("ten31", "ripple121"):
        for P in (16, 64):
            for G in (1, 32):
                cases.append((f"K1 {name} P={P} G={G}", *k1(name, P, None, n_sm * 64, G)))
                cases.append((f"K2 {name} P={P} o1 G={G}", *k2(name, P, 1, n_sm, 64, G)))
    return cases


def dump(path):
    """--dump: the kernels' outputs on the main paths (a strided sample of
    the sweeps' points, every isopleth cell), on K3's parity cases, and on
    the wide builds' cases (wide_cases: a strided sample of 4,096 points),
    with the kernel ms of each wide case and of K3 on its main-path grids
    (CUDA events, warm, the median of 3 reps of WIDE_TIMED_LAUNCHES
    launches, under the "_ms" key)."""
    C = Ctx()
    C.build()
    torch, np, TC, pipeline = C.torch, C.np, C.TC, C.pipeline
    out = {}
    iso_names = ("z", "density", "fe", "ok", "fail_code")
    k3_lanes = "_lanes" in inspect.signature(C.IB.iso_grid).parameters

    def k3_g32(args):
        """K3 at G = 32: forced, or the only layout of a tree without _lanes."""
        got = C.IB.iso_grid(*args, engine="cuda", **({"_lanes": 32} if k3_lanes else {}))
        return dict(zip(iso_names, (t.cpu() for t in got)))

    def sample(o, lead):
        """o's tensors with `lead` leading axes flattened, every k-th point."""
        flat = {k: v.reshape((-1,) + v.shape[lead:]) for k, v in o.items()}
        B = flat["fe"].shape[0]
        idx = torch.arange(0, B, max(1, B // DUMP_POINTS), device=C.dev)
        return {k: v[idx].cpu() for k, v in flat.items()}

    for cname in MAIN_CELLS:
        d, mk, mus = TC.cell(cname)
        o = pipeline.mu_sweep_thermo(C.hist(d), C.state.HistMeta(**mk), torch.as_tensor(mus, device=C.dev), props=True)
        out[f"K1 {cname}"] = sample(o, 1)
    d, mk, mus, betas, dmus = TC.mb_grid()
    h, meta = C.hist(d), C.state.HistMeta(**mk)
    for order in MB_ORDERS:
        o = pipeline.mu_beta_sweep_thermo(h, meta, torch.as_tensor(mus, device=C.dev), betas, dmus, order=order, props=True)
        out[f"K2 mb31_o{order}"] = sample(o, 2)
    ms = {}
    for cname, gname, order in ISO_CELLS:
        g, iso, grid, srcs, mk, lr, wts, mu1_v, dmu2_v = C.iso_main(gname, order)
        iso.make_grid(*grid)
        out[f"K3 {cname}"] = {k: torch.as_tensor(np.asarray(iso.data[k])) for k in ("Z", "density", "F.E./kT", "valid", "fail_code")}
        metas = [C.state.HistMeta(**dict(mk, max_phases=8))] * len(srcs)
        out[f"K3 {cname} G=32"] = k3_g32((srcs, metas, mu1_v, dmu2_v, lr, wts, g["beta"], order, CUTOFF))
        # the first build's kernel at the rule's G on the main-path grid, timed as the wide cases
        pro = C.IB._iso_prologue(srcs, metas[0], mu1_v, dmu2_v, lr, wts, g["beta"], order, CUTOFF)
        kin = [pro[k] for k in ("lnpi", "op", "xrows", "krows", "a", "edge", "mu", "lr", "wts", "tg", "volume")]

        def k3_launches(kin=kin, sm=mk["smooth"], order=order):
            for _ in range(WIDE_TIMED_LAUNCHES):
                C.cuda_iso.iso_grid(*kin, sm, 8, order, CUTOFF)

        ms[f"K3 {cname}"] = cuda_ms(k3_launches) / WIDE_TIMED_LAUNCHES
        log(f"dump K3 {cname}: kernel {ms[f'K3 {cname}']:.4f} ms | {C.smi}")
    for i, kw in enumerate(k3_cases(np, TC)):
        kw.pop("min_ok", None)
        args = C.iso_args(**kw)
        got = C.IB.iso_grid(*args, engine="cuda")
        out[f"K3 case {i}"] = dict(zip(iso_names, (t.cpu() for t in got)))
        out[f"K3 case {i} G=32"] = k3_g32(args)
    for key, run, kern in wide_cases(C):
        o = run()
        B = next(iter(o.values())).shape[0]
        idx = torch.arange(0, B, max(1, B // WIDE_DUMP_POINTS), device=C.dev)
        out[key] = {k: v[idx].cpu() for k, v in o.items()}
        del o
        def launches(kern=kern):
            for _ in range(WIDE_TIMED_LAUNCHES):
                kern()

        ms[key] = cuda_ms(launches) / WIDE_TIMED_LAUNCHES
        log(f"dump {key}: {B} points, kernel {ms[key]:.4f} ms | {C.smi}")
    out["_ms"] = ms
    torch.cuda.synchronize()
    torch.save(out, path)
    log(f"dump: {len(out) - 1} outputs to {path}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": C.name, "count": torch.cuda.device_count()}}))


def compare_dumps(path_a, path_b):
    """--compare: per output of two dumps, segmentation equal, every field
    bit-identical, and the worst float difference; exits 1 where any
    integer or boolean field differs."""
    import torch

    a, b = torch.load(path_a), torch.load(path_b)
    ms_a, ms_b = a.pop("_ms", {}), b.pop("_ms", {})
    seg_ok = True
    for key, x in a.items():
        y = b.get(key)
        if y is None:
            log(f"compare {key}: missing from {path_b}")
            seg_ok = False
            continue
        seg = all(torch.equal(x[k], y[k]) for k in x if not x[k].is_floating_point())
        bits = seg and all(torch.equal(x[k], y[k]) for k in x)
        worst = {}
        for k in x:
            if x[k].is_floating_point():
                d = torch.where(x[k] == y[k], 0.0, (x[k] - y[k]).abs())
                worst[k] = float(d.max()) if d.numel() else 0.0
        seg_ok &= seg
        log(f"compare {key}: segmentation equal {seg}, bit-identical {bits}, worst float diff", json.dumps({k: float(f"{v:.3e}") for k, v in worst.items()}))
    for key, t in ms_a.items():
        if key in ms_b:
            log(f"compare {key}: kernel ms {t:.4f} ({path_a}) | {ms_b[key]:.4f} ({path_b}) | ratio {ms_b[key] / t:.3f}")
    print(json.dumps({"ok": seg_ok, "compared": len(a), "ms": {k: [ms_a[k], ms_b.get(k)] for k in ms_a}}))
    return 0 if seg_ok else 1


def window_stats(prof, kernel=None, top=0):
    """The device window of a torch.profiler run: its span (first to last
    device op), the busy union of device intervals, the idle share, the
    device time of ops whose name holds ``kernel``, and the ``top`` ops by
    summed device time; None where the profiler recorded no device time."""
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events() if e.device_type.name == "CUDA" and e.time_range.end > e.time_range.start)
    if not spans:
        return None
    busy, end = 0.0, spans[0][0]
    for t0, t1, _ in spans:  # the union of device intervals
        busy += max(0.0, t1 - max(t0, end))
        end = max(end, t1)
    window = spans[-1][1] - spans[0][0]
    out = dict(window_ms=window / 1e3, device_busy_ms=busy / 1e3, idle_share=1 - busy / window, device_ops=len(spans))
    if kernel is not None:
        k_us = sum(t1 - t0 for t0, t1, n in spans if kernel in n)
        out.update(kernel_ms=k_us / 1e3, kernel_share_of_device=k_us / busy)
    if top:
        by = {}
        for t0, t1, n in spans:
            ms, cnt = by.get(n, (0.0, 0))
            by[n] = (ms + (t1 - t0) / 1e3, cnt + 1)
        out["top_ops"] = [dict(name=n[:80], ms=ms, count=cnt) for n, (ms, cnt) in sorted(by.items(), key=lambda kv: -kv[1][0])[:top]]
    return out


def log_window(what, kname, w, smi):
    """One line for a window_stats result (None: not measured)."""
    if w is None:
        log(f"{what}: the profiler recorded no device time (not measured)")
        return
    log(f"{what}: window {w['window_ms']:.3f} ms (first to last device op), device busy {w['device_busy_ms']:.3f} ms, "
        + (f"{kname} {w['kernel_ms']:.3f} ms = {100 * w['kernel_share_of_device']:.1f}% of device time, " if kname else "")
        + f"idle {100 * w['idle_share']:.1f}% of the window, {w['device_ops']} device ops"
        + ("; top ops: " + "; ".join(f"{o['name']} {o['ms']:.3f} ms x{o['count']}" for o in w["top_ops"]) if "top_ops" in w else "") + f" | {smi}")


def compare_2d(want, got, states, where, tol=TOL):
    """Two 2-D sweeps' outputs on the given states: every integer and bool
    field, the labels and the peaks equal; every float within ``tol`` abs,
    with NaN and +-inf in the same places.  Returns the worst float diff."""
    np = sys.modules["numpy"]
    st = np.asarray(states, dtype=int)
    worst = 0.0
    for k, v in want.items():
        if k in ("prop_names", "local_maxima"):
            continue
        a, b = np.asarray(v)[st], np.asarray(got[k])[st]
        if a.dtype.kind != "f":
            if not np.array_equal(a, b):
                bad = st[np.flatnonzero((a != b).reshape(len(st), -1).any(1))][:5].tolist()
                raise AssertionError(f"{where}: {k} differs at states {bad}")
            continue
        same = (a == b) | (np.isnan(a) & np.isnan(b))
        fin = np.isfinite(a) & np.isfinite(b)
        if not (same | fin).all():
            raise AssertionError(f"{where}: {k} has NaN or inf in other places")
        with np.errstate(invalid="ignore"):  # inf - inf where both are the same inf
            d = float(np.abs(np.where(fin & ~same, a - b, 0.0)).max()) if a.size else 0.0
        if not d <= tol:
            raise AssertionError(f"{where}: {k} differs by {d:.3e} > {tol}")
        worst = max(worst, d)
    for s in st:
        if not np.array_equal(want["local_maxima"][s], got["local_maxima"][s]):
            raise AssertionError(f"{where}: local_maxima differ at state {s}")
    return worst


def compare_class(out, s, ph, props, where, tol=TOL):
    """State s of a 2-D sweep against the class engine's phase_average
    (`props`) of the same state (`ph`): phases, labels and surface equal
    or within ``tol``; returns the worst float diff."""
    np = sys.modules["numpy"]
    keys = sorted(k for k in props if isinstance(k, int))
    n = len(keys)
    if int(out["n_phases"][s]) != n or not np.array_equal(np.asarray(out["labels"][s]), ph.data["seg"]["phase_labels"]):
        raise AssertionError(f"{where}: state {s}: phases or labels differ from the class engine's")
    diffs = [abs(out["fe"][s, k] - props[k]["F.E./kT"]) for k in keys]
    diffs += [abs(out["ave"][s, k, j] - props[k][name]) for k in keys for j, name in enumerate(out["prop_names"])]
    diffs += [np.abs(out["act_kT"][s, :n, :n] - props["activation_kT"]).max(), np.abs(out["act_kT_diff"][s, :n, :n] - props["activation_kT_diff"]).max()]
    fin = np.isfinite(ph.data["ln(PI)"])
    if not np.array_equal(np.isfinite(out["lnpi"][s]), fin):
        raise AssertionError(f"{where}: state {s}: the surface's finite cells differ from the class engine's")
    diffs.append(np.abs(out["lnpi"][s][fin] - ph.data["ln(PI)"][fin]).max())
    worst = float(max(diffs))
    if not worst <= tol:
        raise AssertionError(f"{where}: state {s} differs from the class engine's by {worst:.3e} > {tol}")
    return worst


def boundary_bytes(labels, P):
    """Least bytes of the boundary integrals of [S, H, N] labels with P
    label slots: the labels read once (int32); lnPI only where a
    contribution reads it (each contributing boundary cell and its
    neighbour across the boundary), by the 32-byte sectors that hold those
    cells; both f64 [S, P+1, P+1] tables written once."""
    torch = sys.modules["torch"]
    S2 = sys.modules["fhmcanalysis_torch.core.segment2d"]
    lab = labels
    inner = S2._boundary_mask(lab) & (lab > 0) & (lab <= P)
    read = torch.zeros_like(inner)
    for di, dj in S2._NEBR8:
        q = S2._shifted(lab, di, dj, 0)
        c = inner & (q > 0) & (q != lab) & (q <= P)
        read |= c | S2._shifted(c, -di, -dj, False)
    flat = read.reshape(-1)
    flat = torch.cat([flat, flat.new_zeros((-flat.numel()) % 4)])
    sectors = int(flat.view(-1, 4).any(1).sum())
    return lab.numel() * 4 + sectors * 32 + 2 * lab.shape[0] * (P + 1) ** 2 * 8


def compare_boundary(got, want, where):
    """The kernel's (min_df, max_val) against the plain one-hot's on the
    same inputs on the card: -DBL_MAX in the same places, max_val bit for
    bit, min_df within 1e-12 relative (absolute below 1); returns min_df's
    worst absolute gap."""
    torch = sys.modules["torch"]
    big = -sys.float_info.max
    for a, b, k in zip(got, want, ("min_df", "max_val")):
        if a.shape != b.shape or not torch.equal(a == big, b == big):
            raise AssertionError(f"{where}: {k}'s shape or its pairs with no shared boundary differ from the plain one-hot's")
    if not torch.equal(got[1], want[1]):
        raise AssertionError(f"{where}: max_val differs from the plain one-hot's bits")
    fin = want[0] != big
    d = (got[0] - want[0])[fin].abs()
    if not d.numel():
        return 0.0
    rel = float((d / want[0][fin].abs().clamp(min=1.0)).max())
    if not rel <= 1e-12:
        raise AssertionError(f"{where}: min_df differs from the plain one-hot's by {rel:.3e} relative > 1e-12")
    return float(d.max())


def boundary_stage(C, ln, labels, P):
    """The boundary integrals alone on one stage's surfaces and labels (the
    pipelines' engine: the kernel on the card), by CUDA events around the
    call and as the kernel's device time (torch.profiler), held against
    the plain one-hot on the card on the same inputs (compare_boundary),
    which is timed too; and their bound (boundary_bytes at the card's
    memory rate).  A tree from before the kernel times its plain route
    only."""
    S2 = sys.modules["fhmcanalysis_torch.core.segment2d"]

    def run():
        return S2.boundary_pair_integrals(ln, labels, P)

    res = {"of which boundary integrals": cuda_ms(run)}
    if C.cuda_b2d is not None:
        where = f"boundary integrals S={ln.shape[0]}"
        res["boundary max_abs_err"] = compare_boundary(run(), S2._boundary_plain(ln, labels, P, "onehot"), where)
        res["boundary kernel device"] = device_ms(run, "boundary_pairs_kernel")
        res["boundary plain one-hot"] = cuda_ms(lambda: S2._boundary_plain(ln, labels, P, "onehot"))
    res["boundary bound"] = boundary_bytes(labels, P) / HBM_BYTES_PER_S * 1e3
    return res


WS2D_OUTPUTS = ("labels", "n_labels", "peak_lnpi", "peak_sat", "peak_rc", "elev_tie")


def watershed_stage(C, ln, valid, fp, P):
    """The watershed's kernel alone on one stage's surfaces: its six
    outputs held to the plain function's on the card bit for bit, its
    device time (torch.profiler) and the plain function's (CUDA events),
    and its bound: lnPI read once (f64) and the labels written once
    (int32) at the card's memory rate.  A tree from before the kernel
    reports nothing here."""
    if C.cuda_ws2d is None:
        return {}
    S2 = sys.modules["fhmcanalysis_torch.core.segment2d"]
    got, plain = S2.hillclimb_segment_batch(ln, valid, fp, P), S2._hillclimb_plain(ln, valid, fp, P)
    for k in WS2D_OUTPUTS:
        if not C.torch.equal(got[k], plain[k]):
            raise AssertionError(f"watershed S={ln.shape[0]}: {k} differs from the plain function's")
    return {
        "watershed kernel device": device_ms(lambda: S2.hillclimb_segment_batch(ln, valid, fp, P), "watershed_kernel"),
        "watershed plain": cuda_ms(lambda: S2._hillclimb_plain(ln, valid, fp, P)),
        "watershed bound": ln.numel() * (8 + 4) / HBM_BYTES_PER_S * 1e3,
    }


def stage_text(stg):
    """One stage record as a log fragment: times in ms, errors as they are."""
    return ", ".join(f"{k} {v:.3e}" if k.endswith("err") else f"{k} {v:.4f} ms" for k, v in stg.items() if v is not None)


def pore_stages(C, jh, fh, states):
    """The device engine's stages on a pore sweep of the (p, beta) states,
    each timed alone on the previous stage's outputs: the surfaces, the
    watershed, the per-phase analysis (boundary integrals included), and
    the boundary integrals alone (boundary_stage)."""
    torch, np = C.torch, C.np
    from fhmcanalysis_torch.core import segment2d as S2
    from fhmcanalysis_torch.two_dim.pore_pipeline import _footprint

    hd = jh.data
    raw = torch.as_tensor(np.asarray(hd["ln(PI)"], dtype=np.float64), device=C.dev)
    H, N = raw.shape
    edge_np = np.asarray(hd["bounds_idx"][:, 1], dtype=np.int64)
    valid = torch.as_tensor(np.arange(N)[None, :] <= edge_np[:, None], device=C.dev)
    edge = torch.as_tensor(edge_np, device=C.dev)
    props = torch.as_tensor(np.stack([hd["props"][k] for k in hd["props"]]), device=C.dev)
    h_np = np.asarray(hd["op_1"], dtype=np.float64)
    h, fh_v = torch.as_tensor(h_np, device=C.dev), torch.as_tensor(np.array([fh(x) for x in h_np], dtype=np.float64), device=C.dev)
    p, b = (torch.as_tensor(np.asarray(v, dtype=np.float64), device=C.dev) for v in states)
    fp, P = _footprint(H, N, 1).shape, 5
    ln, _ = S2.pore_surface_batch(raw, h, fh_v, p, 1.0, b, valid)
    seg = S2.hillclimb_segment_batch(ln, valid, fp, P)
    return {
        "surfaces": cuda_ms(lambda: S2.pore_surface_batch(raw, h, fh_v, p, 1.0, b, valid)),
        "watershed": cuda_ms(lambda: S2.hillclimb_segment_batch(ln, valid, fp, P)),
        **watershed_stage(C, ln, valid, fp, P),
        "phase analysis": cuda_ms(lambda: S2.pore_phase_batch(ln, seg["labels"], valid, edge, props, seg["peak_lnpi"], seg["n_labels"], P)),
        **boundary_stage(C, ln, seg["labels"], P),
    }


def joint_stages(C, jh, targets):
    """The device engine's stages on a joint sweep, each timed alone on
    the previous stage's outputs: the surfaces, the watershed, the
    per-phase analysis (boundary integrals included) and the boundary
    integrals alone (boundary_stage)."""
    torch, np = C.torch, C.np
    from fhmcanalysis_torch.core import segment2d as S2
    from fhmcanalysis_torch.two_dim.pore_pipeline import _footprint

    hd = jh.data
    raw = torch.as_tensor(hd["ln(PI)"], device=C.dev)
    valid = torch.isfinite(raw)
    edge = torch.as_tensor(np.asarray(hd["bounds_idx"][:, 1], dtype=np.int64), device=C.dev)
    props = torch.as_tensor(np.stack([hd["props"][k] for k in hd["props"]]), device=C.dev)
    op1, op2 = (torch.as_tensor(hd[k], device=C.dev) for k in ("op_1", "op_2"))
    d1, d2 = (torch.as_tensor(targets[:, i] - C.TC.JOINT_MU_REF[i], device=C.dev) for i in (0, 1))
    fp, P = _footprint(*raw.shape, 1).shape, 5
    ln, _ = S2.joint_surface_batch(raw, op1, op2, C.TC.JOINT_BETA, d1, d2, valid)
    seg = S2.hillclimb_segment_batch(ln, valid, fp, P)
    return {
        "surfaces": cuda_ms(lambda: S2.joint_surface_batch(raw, op1, op2, C.TC.JOINT_BETA, d1, d2, valid)),
        "watershed": cuda_ms(lambda: S2.hillclimb_segment_batch(ln, valid, fp, P)),
        **watershed_stage(C, ln, valid, fp, P),
        "phase analysis": cuda_ms(lambda: S2.pore_phase_batch(ln, seg["labels"], valid, edge, props, seg["peak_lnpi"], seg["n_labels"], P)),
        **boundary_stage(C, ln, seg["labels"], P),
    }


def two_dim_phase(C):
    """Phase 5c: the 2-D surface path (core.segment2d under
    two_dim.pore_state_sweep / joint_state_sweep; plain PyTorch on the card
    but for the boundary integrals' kernel) on the pore13, pore96, joint96 and
    joint96_surfaces cells: the device watershed against the host flood,
    both against the class engine (pore_hist(engine="numpy")), the tie and
    saturation cases, states/s, peak memory and a profiler window."""
    torch, np, TC, smi = C.torch, C.np, C.TC, C.smi
    from fhmcanalysis_torch import native, two_dim
    from fhmcanalysis_torch.utils import profiling as prof_mod

    if not native.IMAGING_AVAILABLE:
        raise AssertionError("2-D: the native flood (native/imaging.cpp) did not build with g++")
    fh = two_dim.free_energy_profile.polynomial(TC.FH_COEFFS)
    res = {}

    def cell_setup(cname):
        c = TC.CELLS2D[cname]
        jh = TC.joint(c["entries"]())
        jh.make()  # made once: a made histogram is used read-only
        if c["kind"] == "pore":
            def sweep(states, **kw):
                return two_dim.pore_state_sweep(jh, fh, states[0], states[1], 1.0, nnebr=1, max_peaks=4, device=C.dev, **kw)

            def take(states, idx):
                return states[0][idx], states[1][idx]

            def oracle(states, s):
                ph = two_dim.pore_hist(jh, fh, float(states[0][s]), 1.0, float(states[1][s]), engine="numpy")
                return ph, ph.phase_average(nnebr=1, max_peaks=4)

            def on_card(states, s):
                ph = two_dim.pore_hist(jh, fh, float(states[0][s]), 1.0, float(states[1][s]), device=C.dev)
                return ph, ph.phase_average(nnebr=1, max_peaks=4)
        else:
            def sweep(states, **kw):
                return two_dim.joint_state_sweep(jh, TC.JOINT_BETA, TC.JOINT_MU_REF, states, nnebr=1, max_peaks=4, device=C.dev, **kw)

            def take(states, idx):
                return states[idx]

            def oracle(states, s):
                return TC.joint_class_oracle(jh, TC.JOINT_BETA, TC.JOINT_MU_REF, states[s], 1, 4)

            on_card = None
        return c, jh, sweep, take, oracle, on_card

    def n_states(states):
        return len(states[0]) if isinstance(states, tuple) else len(states)

    b2d_main, ws2d_main = {}, {}  # the boundary and watershed kernels' launches in each main-path device sweep: one a call

    def main_sweep(sweep, states, key):
        n0, w0 = launch_count("b2d"), launch_count("ws2d")
        out = sweep(states, segment_engine="device")
        b2d_main[key], ws2d_main[key] = launch_count("b2d") - n0, launch_count("ws2d") - w0
        if C.cuda_b2d is not None and b2d_main[key] != 1:
            raise AssertionError(f"2-D {key}: the device sweep launched the boundary kernel {b2d_main[key]} times (one a call)")
        if C.cuda_ws2d is not None and ws2d_main[key] != 1:
            raise AssertionError(f"2-D {key}: the device sweep launched the watershed kernel {ws2d_main[key]} times (one a call)")
        return out

    for cname in ("pore13", "pore96", "joint96"):
        c, jh, sweep, take, oracle, on_card = cell_setup(cname)
        st64 = c["states"](c["S"])
        dev = main_sweep(sweep, st64, f"{cname} S={c['S']}")
        host = sweep(st64, segment_engine="host")
        S = c["S"]
        if dev["fe"].shape != (S, 5) or not isinstance(dev["lnpi"], np.ndarray):
            raise AssertionError(f"2-D {cname}: unexpected output shapes or types")
        clean = np.flatnonzero(~dev["elev_tie"] & (dev["fail_code"] != 3) & (host["fail_code"] != 3))
        if clean.size < S // 2 or not (dev["fail_code"][clean] == 0).all():
            raise AssertionError(f"2-D {cname}: {clean.size} of {S} states tie-free and unsaturated, fail codes {np.bincount(dev['fail_code'], minlength=5).tolist()}")
        w_eng = compare_2d(host, dev, clean, f"2-D {cname} device vs host")
        ph_states = np.linspace(0, S - 1, 4).astype(int)
        w_cls = 0.0
        for s in ph_states:
            ph, props = oracle(st64, s)
            w_cls = max(w_cls, compare_class(dev, s, ph, props, f"2-D {cname} device vs class"), compare_class(host, s, ph, props, f"2-D {cname} host vs class"))
        w_card = None
        if on_card is not None:  # the class engine on the card, one state
            ph, props = on_card(st64, ph_states[1])
            w_card = compare_class(dev, ph_states[1], ph, props, f"2-D {cname} device vs class on the card")
        row = dict(S=S, clean_states=int(clean.size), fail_codes=np.bincount(dev["fail_code"], minlength=5).tolist(), phases=np.bincount(dev["n_phases"], minlength=3).tolist(),
                   worst_device_vs_host=w_eng, worst_vs_class=w_cls, worst_class_on_card=w_card)
        # states/s: CUDA events around calls that end in the sweep's own
        # transfer to numpy; warm, median of 3
        torch.cuda.reset_peak_memory_stats()
        row["device_ms"] = cuda_ms(lambda: sweep(st64, segment_engine="device", return_surfaces=False))
        row["device_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        row["host_ms"] = cuda_ms(lambda: sweep(st64, segment_engine="host"))
        if cname == "joint96":  # joint96_surfaces: the same sweep with the surfaces copied to numpy
            torch.cuda.reset_peak_memory_stats()
            row["surfaces_ms"] = cuda_ms(lambda: sweep(st64, segment_engine="device", return_surfaces=True))
            row["surfaces_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        log(f"2-D {cname}: S={S} {jh.data['ln(PI)'].shape[0]}x{jh.data['ln(PI)'].shape[1]} fail codes {row['fail_codes']} phases {row['phases']} | device vs host on {clean.size} tie-free unsaturated states: "
            f"labels, n_phases, local_maxima, fail_code equal, floats within {w_eng:.3e} | both vs pore_hist(engine='numpy') on states {ph_states.tolist()}: within {w_cls:.3e}"
            + (f" | class on the card within {w_card:.3e}" if w_card is not None else "") + f" | {smi}")
        log(f"2-D {cname} times: device {row['device_ms']:.3f} ms = {S / row['device_ms'] * 1e3:.5g} states/s (peak {row['device_peak_gib']:.3f} GiB) | host flood {row['host_ms']:.3f} ms = {S / row['host_ms'] * 1e3:.5g} states/s"
            + (f" | joint96_surfaces (return_surfaces=True) {row['surfaces_ms']:.3f} ms = {S / row['surfaces_ms'] * 1e3:.5g} states/s (peak {row['surfaces_peak_gib']:.3f} GiB)" if "surfaces_ms" in row else "") + f" | {smi}")
        if "grid" in c:  # S = 1,024: a 32 x 32 grid, where the rate levels off
            big = c["grid"](32)
            nb = n_states(big)
            out = main_sweep(sweep, big, f"{cname} S={nb}")
            if out["fe"].shape != (nb, 5) or not np.isfinite(out["fe"][out["phase_ok"]]).all() or not (out["n_phases"] >= 1).all():
                raise AssertionError(f"2-D {cname} S={nb}: shapes, phases or free energies wrong")
            # 64 states spread over the grid against the host flood
            idx = np.linspace(0, nb - 1, 64).astype(int)
            sub = sweep(take(big, idx), segment_engine="host")
            keep = np.flatnonzero(~out["elev_tie"][idx] & (out["fail_code"][idx] != 3) & (sub["fail_code"] != 3))
            sub = {k: v for k, v in sub.items() if k != "elev_tie"}
            out_s = {k: ([v[i] for i in idx] if k == "local_maxima" else v if k == "prop_names" else v[idx]) for k, v in out.items() if k != "elev_tie"}
            w_big = compare_2d(sub, out_s, keep, f"2-D {cname} S={nb} device vs host sample")
            ok = keep
            torch.cuda.reset_peak_memory_stats()
            ms = cuda_ms(lambda: sweep(big, segment_engine="device", return_surfaces=False))
            peak = torch.cuda.max_memory_allocated() / 2**30
            row["big"] = dict(S=nb, device_ms=ms, peak_gib=peak, fail_codes=np.bincount(out["fail_code"], minlength=5).tolist(), sample_states=int(ok.size), worst_device_vs_host=w_big)
            log(f"2-D {cname} S={nb}: device {ms:.3f} ms = {nb / ms * 1e3:.5g} states/s (peak {peak:.3f} GiB) fail codes {row['big']['fail_codes']} | device vs host on {ok.size} sampled states within {w_big:.3e} | {smi}")
            if cname == "pore96":  # where the device engine's time goes, and the boundary integrals at S = 1 (the class path's count)
                row["stages"] = {S_: pore_stages(C, jh, fh, st) for S_, st in ((1, take(big, [0])), (S, st64), (nb, big))}
                for S_, stg in row["stages"].items():
                    log(f"2-D pore96 S={S_} stages (CUDA events, warm, median of 3): " + stage_text(stg) + f" | {smi}")
            if cname == "joint96":  # where the device engine's time goes, and a utils.profiling window over one call
                row["stages"] = {S_: joint_stages(C, jh, st) for S_, st in ((S, st64), (nb, big))}
                for S_, stg in row["stages"].items():
                    log(f"2-D joint96 S={S_} stages (CUDA events, warm, median of 3): " + stage_text(stg) + f" | {smi}")
                with prof_mod.trace(os.path.join(ROOT, "_profiles", "joint96")) as prof:
                    sweep(big, segment_engine="device", return_surfaces=False)
                    torch.cuda.synchronize()
                row["profile"] = window_stats(prof, top=8)
                log_window(f"profile joint96 S={nb} device x1", None, row["profile"], smi)
        res[cname] = row

    # exact elevation ties: fail_code 4 without the fallback, the host flood's
    # answer with it; and saturated peak slots: fail_code 3 on both engines
    jt = TC.tie_joint(TC.joint(TC.pore13_entries()))
    ps, bs = TC.pore_states(8)
    host = two_dim.pore_state_sweep(jt, fh, ps, bs, 1.0, nnebr=1, max_peaks=4, device=C.dev, segment_engine="host")
    flag = two_dim.pore_state_sweep(jt, fh, ps, bs, 1.0, nnebr=1, max_peaks=4, device=C.dev, segment_engine="device")
    if not flag["elev_tie"].all() or not (flag["fail_code"][host["fail_code"] == 0] == 4).all():
        raise AssertionError("2-D tie: every state must be flagged, and the clean ones report fail_code 4")
    for rs in (True, False):
        fb = two_dim.pore_state_sweep(jt, fh, ps, bs, 1.0, nnebr=1, max_peaks=4, device=C.dev, segment_engine="device", tie_fallback=True, return_surfaces=rs)
        if (fb["fail_code"] == 4).any():
            raise AssertionError("2-D tie: tie_fallback left fail_code 4")
        if not rs:
            fb = dict(fb, lnpi=fb["lnpi"].cpu().numpy(), labels=fb["labels"].cpu().numpy())
        w_tie = compare_2d(dict(host, elev_tie=fb["elev_tie"]), fb, np.arange(len(ps)), f"2-D tie_fallback (return_surfaces={rs}) vs host")
    sat_h = two_dim.pore_state_sweep(TC.joint(TC.pore13_entries()), fh, ps, bs, 1.0, nnebr=1, max_peaks=0, device=C.dev, segment_engine="host")
    sat_d = two_dim.pore_state_sweep(TC.joint(TC.pore13_entries()), fh, ps, bs, 1.0, nnebr=1, max_peaks=0, device=C.dev, segment_engine="device")
    if not ((sat_h["fail_code"] == 3).all() and np.array_equal(sat_h["fail_code"], sat_d["fail_code"]) and np.array_equal(sat_h["n_phases"], sat_d["n_phases"])):
        raise AssertionError(f"2-D saturation: fail codes host {sat_h['fail_code'].tolist()} device {sat_d['fail_code'].tolist()}")
    res["tie"] = dict(states=len(ps), worst_fallback_vs_host=w_tie)
    res["b2d_main_path_launches"] = b2d_main
    res["ws2d_main_path_launches"] = ws2d_main
    log(f"2-D tie case: {len(ps)} pore13 states with a plateau pair: device flags all (fail_code 4 on the clean ones), tie_fallback equals the host flood within {w_tie:.3e} "
        f"(return_surfaces True and False) | saturation (max_peaks=0): fail_code 3 on all {len(ps)} states on both engines | {smi}")
    return res


def host_ms(fn, reps=3):
    """Median host wall time of fn in ms, warm (one call first)."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def cpu_model():
    """The host CPU as /proc/cpuinfo names it: its "model name", or where a
    virtual machine reports that as unknown, the vendor, family, model and
    clock; with the cores this process sees."""
    import platform

    info = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if not line.strip():
                    break  # the first processor is enough
                key, _, value = line.partition(":")
                info[key.strip()] = value.strip()
    except OSError:
        pass
    name = info.get("model name", "unknown")
    if name == "unknown":
        name = "%s family %s model %s, %s MHz" % tuple(info.get(k, "?") for k in ("vendor_id", "cpu family", "model", "cpu MHz"))
        if not info:
            name = platform.machine()
    return f"{name} ({len(os.sched_getaffinity(0))} cores)"


def win_patch_phase(C, worst):
    """Phase 5d: window patching (win_patch, host numpy over the native
    table reader) into a composite that K1 sweeps on the card, on the
    win800 cell: FHMCSimulation windows cut from a known composite
    (torch_windows.WIN800) in final_* and checkpoint-named copies ->
    get_patch_sequence -> test_nebr_equil(trust=True) -> the steps of
    fhmc_patch._drive_patch in memory (no h5py on this machine) at offset
    1, smooth False and True -> histogram.from_composite(device=card) ->
    pipeline.mu_sweep_thermo(engine="auto").  Returns the phase's record
    and K1's cell for the kernels line; K1 against its plain version on a
    sample goes into `worst`."""
    import tempfile

    torch, np, TC, smi = C.torch, C.np, C.TC, C.smi
    import torch_windows as TW
    from fhmcanalysis_torch import native
    from fhmcanalysis_torch.histogram.ntot import histogram
    from fhmcanalysis_torch.win_patch import fhmc_equil, fhmc_patch, windows

    if not native.NATIVE_AVAILABLE:
        raise AssertionError("win_patch: the native table reader (native/fast_table.cpp) did not build with g++")
    cuda_sweep, pipeline, segment, state = C.cuda_sweep, C.pipeline, C.segment, C.state
    c = TW.WIN800
    src = TW.ntot_source(c["N"], c["nspec"], c["max_order"], c["seed"], c["beta"], c["mu0"])
    bounds = windows.ntot_window_scaling(*c["windows"])
    if len(bounds) != 20 or bounds[0][0] != 0 or bounds[-1][1] != c["N"] - 1:
        raise AssertionError(f"win800: window set {bounds}")
    mus = torch.as_tensor(np.linspace(*TC.mu_window(**c), c["B"]), device=C.dev)
    res = dict(cell="win800", N=c["N"], nspec=c["nspec"], max_order=c["max_order"], windows=len(bounds),
               bins=[min(u - lo for lo, u in bounds), max(u - lo for lo, u in bounds)], overlap=c["windows"][3], offset=c["offset"], B=c["B"])

    def sweep(h, engine="auto"):
        out = pipeline.mu_sweep_thermo(h._hist(), h._meta(max_phases=c["max_phases"]), mus, props=True, engine=engine)
        torch.cuda.synchronize()
        return out

    raw_src = TC.composite_raw(src, c["nspec"], c["max_order"])
    want = sweep(histogram.from_composite(raw_src, c["beta"], list(c["mu0"]), smooth=c["smooth"], device=C.dev))
    nph = torch.bincount(want["n_phases"].long(), minlength=3).tolist()
    if not bool(want["valid"].all()) or nph[1] == 0 or nph[2] == 0:
        raise AssertionError(f"win800: the source's sweep must be valid and cross from one phase to two, phases {nph}")

    with tempfile.TemporaryDirectory(prefix="win800_") as tmp:
        trees = {"final": os.path.join(tmp, "final"), "checkpoint": os.path.join(tmp, "checkpoint")}
        t0 = time.perf_counter()
        TW.write_fhmc(trees["final"], src, bounds, seed=c["seed"])
        TW.write_fhmc(trees["checkpoint"], src, bounds, seed=c["seed"], checkpoints=TW.checkpoint_sets(len(bounds)))
        res["write_s"] = time.perf_counter() - t0
        files = sorted(os.path.join(d, f) for t in trees.values() for d, _, fs in os.walk(t) for f in fs)
        tables = [f for f in files if f.endswith("_lnPI.dat") or "extMom" in f]
        res["files"], res["tables"], res["bytes"] = len(files), len(tables), sum(os.path.getsize(f) for f in files)

        # the native parser against the numpy one on every table of both trees
        for f in tables:
            a, b = native.read_table(f), native.numpy_table(f)
            if a.shape != b.shape or not np.array_equal(a, b):
                bad = np.argwhere(a != b)[:1].tolist() if a.shape == b.shape else "shape %s vs %s" % (a.shape, b.shape)
                raise AssertionError(f"win800: native and numpy parsers differ on {os.path.relpath(f, tmp)} at {bad}")
        res["parse_ms"] = {"native": host_ms(lambda: [native.read_table(f) for f in tables]),
                           "numpy": host_ms(lambda: [native.numpy_table(f) for f in tables])}

        seqs = {k: fhmc_patch.get_patch_sequence(t) for k, t in trees.items()}
        top = ["tmmc-Checkpoint-%d_lnPI.dat" % max(k) for k in TW.checkpoint_sets(len(bounds))]
        if len(seqs["final"]) != 20 or [s[0].rsplit("/", 1)[1] for s in seqs["checkpoint"]] != top:
            raise AssertionError("win800: get_patch_sequence missed a window or the highest checkpoint")
        res["host_ms"] = {"scan_" + k: host_ms(lambda: fhmc_patch.get_patch_sequence(t)) for k, t in trees.items()}
        maxeq = os.path.join(tmp, "maxEq")
        safe = fhmc_equil.test_nebr_equil(seqs["final"], 1.0, maxeq, trust=True)
        if safe != seqs["final"]:
            raise AssertionError(f"win800: test_nebr_equil kept {len(safe)} of 20 windows")
        res["host_ms"]["equilibration"] = host_ms(lambda: fhmc_equil.test_nebr_equil(seqs["final"], 1.0, maxeq, trust=True))

        res["smooth"], k1 = {}, None
        for smooth in (False, True):
            comp, _, err = TW.patch_in_memory(fhmc_patch, safe, c["offset"], smooth)
            alt, _, _ = TW.patch_in_memory(fhmc_patch, seqs["checkpoint"], c["offset"], smooth)
            for k in ("lnpi", "op", "mom"):
                if not np.array_equal(comp[k], alt[k]):
                    raise AssertionError(f"win800 smooth={smooth}: the checkpoint-named tree patches to another {k}")
            d_ln = np.abs(comp["lnpi"] - src["lnpi"])
            scale = np.where(src["mom"] == 0.0, 1.0, np.abs(src["mom"]))
            d_mom = np.abs(comp["mom"] - src["mom"]) / scale
            if not d_ln.max() <= 1e-10:
                raise AssertionError(f"win800 smooth={smooth}: lnPI differs from the source's by {d_ln.max():.3e} at N = {int(d_ln.argmax())}")
            if not d_mom.max() <= 1e-12:
                at = np.unravel_index(int(d_mom.argmax()), d_mom.shape)
                raise AssertionError(f"win800 smooth={smooth}: moments differ from the source's by {d_mom.max():.3e} relative at {tuple(int(i) for i in at)}")
            patch = host_ms(lambda: TW.patch_in_memory(fhmc_patch, safe, c["offset"], smooth))

            def k1_call():
                return sweep(histogram.from_composite(comp, c["beta"], list(c["mu0"]), smooth=c["smooth"], device=C.dev))

            start_k1 = launch_count("k1")
            got = k1_call()
            launches = launch_count("k1") - start_k1
            if launches < 1:
                raise AssertionError(f"win800 smooth={smooth}: the main path launched K1 {launches} times")
            if got["fe"].shape != (c["B"], c["max_phases"]) or not bool(torch.isfinite(got["fe"][got["mask"]]).all()):
                raise AssertionError(f"win800 smooth={smooth}: K1's output has the wrong shape or a non-finite free energy")
            w_src = compare(got, want, True, f"win800 smooth={smooth} patched vs source composite")
            hc = histogram.from_composite(comp, c["beta"], list(c["mu0"]), smooth=c["smooth"], device=C.dev)
            idx = torch.as_tensor(np.random.default_rng(800).choice(c["B"], 4096, replace=False), device=C.dev)
            plain = pipeline.mu_sweep_thermo(hc._hist(), hc._meta(max_phases=c["max_phases"]), mus[idx], props=True, engine="torch")
            w_plain = compare({k: v[idx] for k, v in got.items()}, plain, True, f"win800 smooth={smooth} K1 vs plain sample")
            for k, v in w_plain.items():
                worst[k] = max(worst.get(k, 0.0), v)
            res["smooth"][str(smooth)] = dict(launches=launches, worst_patch_err=err, lnpi_abs=float(d_ln.max()), mom_rel=float(d_mom.max()),
                                              k1_vs_source=w_src, k1_vs_plain=w_plain, patch_ms=patch, from_composite_k1_ms=host_ms(k1_call))
            log(f"win800 smooth={smooth}: 20 windows -> N={len(comp['lnpi'])}, lnPI within {d_ln.max():.3e} of the source, moments within {d_mom.max():.3e} relative "
                f"(checkpoint-named tree identical) | K1 launches={launches}, patched vs source composite: segmentation equal, floats within "
                f"{max(w_src.values()):.3e}; vs plain within {max(w_plain.values()):.3e} | host: patch {patch:.1f} ms, from_composite + K1 "
                f"{res['smooth'][str(smooth)]['from_composite_k1_ms']:.1f} ms | {smi}")
            if smooth:  # the kernels line's cell: K1 alone on the patched composite
                h, meta = hc._hist(), hc._meta(max_phases=c["max_phases"])
                a = pipeline._reweight_coeff(h, mus)
                keys = segment.key_rows(h.mom, meta).contiguous()
                ops = tail_ops(got, c["B"], h.nbins, meta.smooth, 2, 2 * (meta.nspec + 1))
                b_ms, b_by = bound([h.lnpi, h.op, keys, h.volume, a], got.values(), ops)
                k1 = dict(B=c["B"], N=h.nbins, lanes=cuda_sweep.lanes_per_point(h.nbins, c["B"], cuda_sweep.sm_count(C.dev.index)), launches=launches,
                          kernel_ms=cuda_ms(lambda: cuda_sweep.sweep_thermo(h.lnpi, h.op, keys, h.volume, a, meta.smooth, meta.max_phases, True)),
                          plain_ms=cuda_ms(lambda: pipeline.mu_sweep_thermo(h, meta, mus, props=True, engine="torch")),
                          auto_ms=cuda_ms(lambda: pipeline.mu_sweep_thermo(h, meta, mus, props=True)), bound_ms=b_ms, bound_by=b_by, ops=ops,
                          phases=torch.bincount(got["n_phases"].long(), minlength=3).tolist()[1:3], covered_bins=covered_bins(got))
    res["host_cpu"], res["card"] = cpu_model(), smi
    log(f"win800: {res['files']} files ({res['bytes'] / 2**20:.1f} MiB) written in {res['write_s']:.2f} s; {res['tables']} tables parsed native "
        f"{res['parse_ms']['native']:.1f} ms, numpy {res['parse_ms']['numpy']:.1f} ms (equal); host: scan {res['host_ms']['scan_final']:.2f} / "
        f"{res['host_ms']['scan_checkpoint']:.2f} ms (final / checkpoint names), equilibration {res['host_ms']['equilibration']:.1f} ms | "
        f"K1 alone {k1['kernel_ms']:.3f} ms, plain {k1['plain_ms']:.3f} ms | host CPU {res['host_cpu']} | {smi}")
    return res, k1


def hold(got, want, same_g, where):
    """A sharded route's outputs against the one-device call's (dicts of
    tensors or numpy arrays; 2-D sweep dicts with prop_names and
    local_maxima): integer and boolean fields equal; floats bit for bit
    where every shard ran the one-device call's G (same_g), else within
    TOL with NaN and +-inf in the same places.  Returns (bit-identical,
    worst float difference)."""
    import numpy as np
    import torch

    bits, worst = True, 0.0
    if set(got) != set(want):
        raise AssertionError(f"{where}: keys {sorted(set(got) ^ set(want))} differ")
    for k, w in want.items():
        g = got[k]
        if k == "prop_names":
            if g != w:
                raise AssertionError(f"{where}: prop_names differ")
            continue
        if k == "local_maxima":
            if len(g) != len(w) or not all(np.array_equal(a, b) for a, b in zip(g, w)):
                raise AssertionError(f"{where}: local maxima differ")
            continue
        if torch.is_tensor(w):
            g = g.to(w.device)
        else:
            g, w = torch.as_tensor(np.asarray(g)), torch.as_tensor(np.asarray(w))
        if g.shape != w.shape:
            raise AssertionError(f"{where}: {k} has shape {tuple(g.shape)}, the one-device call {tuple(w.shape)}")
        if not w.is_floating_point():
            if not torch.equal(g, w):
                raise AssertionError(f"{where}: {k} differs at {(g != w).nonzero()[:5].tolist()}")
            continue
        same = (g == w) | (g.isnan() & w.isnan())
        d = torch.where(same, 0.0, (g - w).abs())
        dk = float(d.max()) if d.numel() else 0.0
        bits &= dk == 0.0
        if not dk <= TOL:
            raise AssertionError(f"{where}: {k} differs by {dk:.3e} > {TOL}")
        worst = max(worst, dk)
    if same_g and not bits:
        raise AssertionError(f"{where}: every shard ran the one-device call's G, yet the floats are not bit-identical (worst {worst:.3e})")
    return bits, worst


def parallel_phase(C):
    """Phase 5e: parallel/ on the card, over the machine's cards
    (grid_mesh()) and over four shards of card 0 (grid_mesh(4, devices=
    [card] * 4)): shard_map_mu_sweep on n573 (K1), sharded_mu_beta_sweep
    on mb31 at order 1 (K2), sharded_trace_coexistence on coex573 (K2's
    paired mode), sharded_make_grid on iso31_o1 and iso1400_o1 (K3),
    sharded_pore_state_sweep / sharded_joint_state_sweep on pore96 and
    joint96 at S = 1,024, and surface.py on the n1400 composite's lnPI
    (smooth 2 and 60) and on pore96's surface.  Each route's launch
    counter is set to 0 just before it and read just after: each shard
    launches its kernel once (the trace: at least three times a shard);
    the thread's current device is the same before and after each call;
    the outputs equal the one-device call's (hold), floats bit for bit
    where every shard ran its G.  Sharded and one-device times with CUDA
    events (warm, median of 3).  Returns the phase's record and the
    kernels line's sharded cells by kernel name."""
    torch, np, TC, smi, dev = C.torch, C.np, C.TC, C.smi, C.dev
    from fhmcanalysis_torch import parallel, two_dim
    from fhmcanalysis_torch.core import numerics, segment2d
    from fhmcanalysis_torch.core import solve as SV

    cuda_sweep, cuda_mb, cuda_iso, pipeline, segment, state = C.cuda_sweep, C.cuda_mb, C.cuda_iso, C.pipeline, C.segment, C.state
    n_sm = cuda_sweep.sm_count(dev.index)
    meshes = {"cards": parallel.grid_mesh(), "x4": parallel.grid_mesh(4, devices=[dev] * 4)}
    res = {name: dict(shape=mesh.shape, devices=[str(d) for d in mesh.device_list()]) for name, mesh in meshes.items()}
    cells = {cuda_sweep.NAME: {}, cuda_mb.NAME: {}, cuda_iso.NAME: {}}

    def driven(kernel, fn):
        """fn() and the launches of kernel ("k1", "k2", "k3") it made;
        the current device must not move."""
        before = torch.cuda.current_device()
        start = launch_count(kernel)
        out = fn()
        torch.cuda.synchronize()
        n = launch_count(kernel) - start
        if torch.cuda.current_device() != before:
            raise AssertionError(f"the sharded call left card {torch.cuda.current_device()} current, not {before}")
        return out, n

    def sizes(n, shards):
        return [len(b) for b in np.array_split(np.arange(n), shards) if len(b)]

    def record(name, kname, cname, row, sharded, single):
        row.update(sharded_ms=cuda_ms(sharded), single_ms=cuda_ms(single))
        res[name][cname] = row
        if kname is not None:
            cells[kname][f"{cname} mesh {name}"] = row
        log(f"parallel {name} {cname}: shards {row['shards']} launches {row.get('launches', '-')} G per shard {row.get('lanes', '-')} (one device G={row.get('single_lanes', '-')}) | "
            f"bit-identical to the one-device call {row['bit_identical']}, worst float diff {row['worst']:.3e} | sharded {row['sharded_ms']:.3f} ms, one device {row['single_ms']:.3f} ms | {smi}")

    d573, mk573, mus573 = TC.cell("n573")
    h573, m573 = C.hist(d573), state.HistMeta(**mk573)
    mus573 = torch.as_tensor(mus573, device=dev)
    dmb, mkmb, musmb, betas, dmus = TC.mb_grid()
    hmb, mmb = C.hist(dmb), state.HistMeta(**mkmb)
    musmb = torch.as_tensor(musmb, device=dev)
    dco, mkco, betas_co, guess, kwco = TC.coex_grid()
    hco, mco = C.hist(dco), state.HistMeta(**mkco)
    d1400, _, _ = TC.cell("n1400")
    x1400 = torch.as_tensor(d1400["lnpi"], device=dev)
    fh = two_dim.free_energy_profile.polynomial(TC.FH_COEFFS)
    cells2d = {}
    for cname in ("pore96", "joint96"):
        c = TC.CELLS2D[cname]
        jh = TC.joint(c["entries"]())
        jh.make()
        cells2d[cname] = (c["kind"], jh, c["grid"](32))
    pore_raw = np.asarray(cells2d["pore96"][1].data["ln(PI)"], dtype=np.float64)
    pore_edge = np.asarray(cells2d["pore96"][1].data["bounds_idx"][:, 1])
    pore_valid = torch.as_tensor(np.arange(pore_raw.shape[1])[None, :] <= pore_edge[:, None], device=dev)
    pore_x = torch.as_tensor(pore_raw, device=dev)

    for name, mesh in meshes.items():
        k = mesh.size

        # K1: the mu sweep on n573
        single = pipeline.mu_sweep_thermo(h573, m573, mus573)
        (got, fe_min), n = driven("k1", lambda: parallel.shard_map_mu_sweep(mesh, h573, m573, mus573))
        B = mus573.shape[0]
        lanes = [cuda_sweep.lanes_per_point(h573.nbins, b, n_sm) for b in sizes(B, k)]
        g1 = cuda_sweep.lanes_per_point(h573.nbins, B, n_sm)
        if n != k:
            raise AssertionError(f"parallel {name} n573: {n} K1 launches for {k} shards")
        bits, w = hold(got, single, all(G == g1 for G in lanes), f"parallel {name} n573")
        want_min = torch.where(single["mask"], single["fe"], torch.inf).min()
        if bits and not torch.equal(fe_min, want_min):
            raise AssertionError(f"parallel {name} n573: global min fe {float(fe_min)} != {float(want_min)}")
        record(name, cuda_sweep.NAME, "n573", dict(B=B, N=h573.nbins, shards=k, launches=n, lanes=lanes, single_lanes=g1, bit_identical=bits, worst=w),
               lambda: parallel.shard_map_mu_sweep(mesh, h573, m573, mus573), lambda: pipeline.mu_sweep_thermo(h573, m573, mus573))
        del single, got

        # K2's product mode: the (mu, beta, dMu) sweep on mb31 at order 1
        single = pipeline.mu_beta_sweep_thermo(hmb, mmb, musmb, betas, dmus, order=1)
        (got, _), n = driven("k2", lambda: parallel.sharded_mu_beta_sweep(mesh, hmb, mmb, musmb, betas, dmus, order=1))
        M, A = musmb.shape[0], len(betas)
        lanes = [cuda_mb.lanes_per_point(hmb.nbins, b * A, n_sm) for b in sizes(M, k)]
        g1 = cuda_mb.lanes_per_point(hmb.nbins, M * A, n_sm)
        if n != k:
            raise AssertionError(f"parallel {name} mb31_o1: {n} K2 launches for {k} shards")
        bits, w = hold(got, single, all(G == g1 for G in lanes), f"parallel {name} mb31_o1")
        record(name, cuda_mb.NAME, "mb31_o1", dict(M=M, A=A, N=hmb.nbins, shards=k, launches=n, lanes=lanes, single_lanes=g1, bit_identical=bits, worst=w),
               lambda: parallel.sharded_mu_beta_sweep(mesh, hmb, mmb, musmb, betas, dmus, order=1), lambda: pipeline.mu_beta_sweep_thermo(hmb, mmb, musmb, betas, dmus, order=1))
        del single, got

        # K2's paired mode: the coexistence trace on coex573, betas split
        single = SV.trace_coexistence(hco, mco, betas_co, guess, **kwco)
        got, n = driven("k2", lambda: parallel.sharded_trace_coexistence(mesh, hco, mco, betas_co, guess, **kwco))
        T = len(betas_co)
        lanes = [cuda_mb.lanes_per_point(hco.nbins, 5 * b, n_sm) for b in sizes(T, k)]  # a step: 5 candidates a beta
        g1 = cuda_mb.lanes_per_point(hco.nbins, 5 * T, n_sm)
        if n < 3 * k or not bool(got["converged"].all()):
            raise AssertionError(f"parallel {name} coex573: {n} K2 launches for {k} shards, {int(got['converged'].sum())}/{T} converged")
        bits, w = hold(got, single, all(G == g1 for G in lanes), f"parallel {name} coex573")
        record(name, cuda_mb.NAME, "coex573", dict(T=T, N=hco.nbins, shards=k, launches=n, lanes=lanes, single_lanes=g1, bit_identical=bits, worst=w),
               lambda: parallel.sharded_trace_coexistence(mesh, hco, mco, betas_co, guess, **kwco), lambda: SV.trace_coexistence(hco, mco, betas_co, guess, **kwco))

        # K3: make_grid on iso31_o1 and iso1400_o1, mu_1 columns split
        for cname, gname in (("iso31_o1", "ISO31"), ("iso1400_o1", "ISO1400")):
            g, iso, grid, srcs, mk, lr, wts, mu1_v, dmu2_v = C.iso_main(gname, 1)
            keys = ("Z", "density", "F.E./kT", "valid", "fail_code")
            iso.make_grid(*grid)
            single = {key: iso.data[key].copy() for key in keys}
            _, n = driven("k3", lambda: parallel.sharded_make_grid(mesh, iso, *grid))
            NX, NY, N = g["NX"], g["NY"], srcs[0].nbins
            cols = sizes(NX, k)
            lanes = [cuda_iso.lanes_per_cell(N, NY * b, n_sm) for b in cols]
            g1 = cuda_iso.lanes_per_cell(N, NY * NX, n_sm)
            if n != len(cols):
                raise AssertionError(f"parallel {name} {cname}: {n} K3 launches for {len(cols)} column blocks")
            bits, w = hold({key: iso.data[key] for key in keys}, single, all(G == g1 for G in lanes), f"parallel {name} {cname}")
            record(name, cuda_iso.NAME, cname, dict(NX=NX, NY=NY, N=N, shards=k, columns=cols, launches=n, lanes=lanes, single_lanes=g1, bit_identical=bits, worst=w),
                   lambda: parallel.sharded_make_grid(mesh, iso, *grid), lambda: iso.make_grid(*grid))

        # the 2-D device sweeps at S = 1,024 (no kernel of their own)
        for cname, (kind, jh, states) in cells2d.items():
            if kind == "pore":
                def one(**kw):
                    return two_dim.pore_state_sweep(jh, fh, states[0], states[1], 1.0, nnebr=1, max_peaks=4, device=dev, **kw)

                def sharded(**kw):
                    return parallel.sharded_pore_state_sweep(mesh, jh, fh, states[0], states[1], 1.0, nnebr=1, max_peaks=4, **kw)

                S = len(states[0])
            else:
                def one(**kw):
                    return two_dim.joint_state_sweep(jh, TC.JOINT_BETA, TC.JOINT_MU_REF, states, nnebr=1, max_peaks=4, device=dev, **kw)

                def sharded(**kw):
                    return parallel.sharded_joint_state_sweep(mesh, jh, TC.JOINT_BETA, TC.JOINT_MU_REF, states, nnebr=1, max_peaks=4, **kw)

                S = len(states)
            before = torch.cuda.current_device()
            got = sharded()
            if torch.cuda.current_device() != before:
                raise AssertionError(f"parallel {name} {cname}: the sharded call left another card current")
            bits, w = hold(got, one(), False, f"parallel {name} {cname} S={S}")  # the per-phase averages are one einsum over a shard's states
            record(name, None, f"{cname} S={S}", dict(S=S, shards=k, states=sizes(S, k), bit_identical=bits, worst=w),
                   lambda: sharded(return_surfaces=False), lambda: one(return_surfaces=False))

        # surface.py: the halo stencil and extrema on n1400's lnPI, the
        # normalizations on it and on pore96's surface
        for smooth in (2, 60):
            fm, fn = segment.stencil_flags(x1400[None], smooth)
            gm, gn = parallel.sharded_stencil_flags(mesh, x1400, smooth)
            ext = segment.relextrema(x1400[None], smooth, 8)
            got = parallel.sharded_relextrema(mesh, x1400, smooth, 8)
            if not (torch.equal(torch.cat(gm), fm[0]) and torch.equal(torch.cat(gn), fn[0])):
                raise AssertionError(f"parallel {name} n1400 smooth={smooth}: stencil flags differ")
            for f in ("maxima", "n_max", "minima", "n_min", "valid"):
                if not torch.equal(getattr(got, f), getattr(ext, f)[0]):
                    raise AssertionError(f"parallel {name} n1400 smooth={smooth}: relextrema's {f} differs")
            record(name, None, f"n1400 relextrema smooth={smooth}", dict(N=x1400.shape[0], shards=k, bins_per_shard=x1400.shape[0] // k, halo_fallback=smooth >= x1400.shape[0] // k,
                                                                           bit_identical=True, worst=0.0, n_max=int(ext.n_max[0])),
                   lambda: parallel.sharded_relextrema(mesh, x1400, smooth, 8), lambda: segment.relextrema(x1400[None], smooth, 8))
        w_long = float((torch.cat(parallel.sharded_normalize_long(mesh, x1400)) - numerics.normalize_lnpi(x1400)).abs().max())
        got2 = torch.cat(parallel.sharded_normalize_2d(mesh, pore_x, pore_valid))
        w_2d = float((got2 - segment2d.normalize_2d(pore_x, pore_valid))[pore_valid].abs().max())
        if not (w_long <= 1e-12 and w_2d <= 1e-12):
            raise AssertionError(f"parallel {name}: normalize_long within {w_long:.3e}, normalize_2d within {w_2d:.3e} (bar 1e-12)")
        record(name, None, "n1400 normalize_long", dict(N=x1400.shape[0], shards=k, bit_identical=w_long == 0.0, worst=w_long),
               lambda: parallel.sharded_normalize_long(mesh, x1400), lambda: numerics.normalize_lnpi(x1400))
        record(name, None, "pore96 normalize_2d", dict(rows=pore_x.shape[0], shards=k, rows_per_shard=pore_x.shape[0] // k, bit_identical=w_2d == 0.0, worst=w_2d),
               lambda: parallel.sharded_normalize_2d(mesh, pore_x, pore_valid), lambda: segment2d.normalize_2d(pore_x, pore_valid))
    return res, cells


# K2's and K3's operation counts as extrap_rows.cuh forms them (see the main paths)
def k2_ops(S, order):
    """(x_ops, key_ops) of K2: reweight, dB term, dd term, order-2 terms
    (3 products, 2 sums, the half); key' per row, then its multiply-add."""
    x_ops = 2 + 4 + (2 if S == 2 else 0) + (7 if order == 2 else 0)
    return x_ops, (S + 1) * (2 + 2 + 2 + (7 if order == 2 else 0))


def k3_ops(order):
    """(x_ops, key_ops) of K3: two sides' x' (as K2) and the mix (2
    products, a sum, a divide); per key row two sides' key', the mix and
    the multiply-add."""
    return 2 * (2 + 4 + 2 + (7 if order == 2 else 0)) + 4, 3 * (2 * (4 + (7 if order == 2 else 0)) + 4 + 2)


def once_ms(fn):
    """(fn(), its time on the device with CUDA events): one run, for the
    plain versions that take seconds at these sizes."""
    import torch

    torch.cuda.synchronize()
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    out = fn()
    e.record()
    torch.cuda.synchronize()
    return out, s.elapsed_time(e)


def capacity_k3(C, note, cells):
    """Phase 5f's K3 cells: make_grid on overflow31 (iso31's 301 x 834
    cells) and overflow1400 (iso1400's 128 x 128 at N = 1400) at 8, 16 and
    64 slots with the sources' _meta raised, K3's launch counter read
    just before and again just after, held against the plain version; at 16
    and 64 the bare wrapper forced to G = 1 and 32 too, and the x_m area
    its library reserves.  Fills cells {name: run},
    calls note(worst) per comparison; returns {(cell, G): x_m bytes}."""
    torch, np, TC, dev, smi = C.torch, C.np, C.TC, C.dev, C.smi
    cuda_sweep, cuda_iso, segment, state, IB, launch = C.cuda_sweep, C.cuda_iso, C.segment, C.state, C.IB, C.launch
    n_sm = cuda_sweep.sm_count(dev.index)
    xm_areas = {}  # (cell, G) -> the wide build's x_m area a block reserves
    for oname in ("overflow31", "overflow1400"):
        ds, mk3, mu1_g, dmu2_g, beta = C.overflow_inputs(oname)
        NX, NY = len(mu1_g), len(dmu2_g)
        mu1_b, dmu2_b = (mu1_g[0], mu1_g[-1]), (dmu2_g[0], dmu2_g[-1])
        grid = (mu1_b, dmu2_b, ((mu1_b[1] - mu1_b[0]) / (NX - 1) * (1 + 1e-9), (dmu2_b[1] - dmu2_b[0]) / (NY - 1) * (1 + 1e-9)))
        for P in (8, 16, 64):
            hs = [TC.port_histogram(dd, mk3, device=dev) for dd in ds]
            for hh in hs:  # the remedy fail code 3 names: a larger max_phases in _meta()
                hh._meta = lambda max_phases=P, _m=type(hh)._meta, _h=hh: _m(_h, max_phases)
            iso = C.iso_cls(hs, beta, order=1)
            cname = f"{oname} P={P}"
            start_k3 = launch_count("k3")
            iso.make_grid(*grid)
            torch.cuda.synchronize()
            launches = launch_count("k3") - start_k3
            got = tuple(torch.as_tensor(np.asarray(iso.data[k]), device=dev) for k in ("Z", "density", "F.E./kT", "valid", "fail_code"))
            if launches != 1 or got[4].shape != (NY, NX):
                raise AssertionError(f"capacity K3 {cname}: {launches} launches, grid {tuple(got[4].shape)}")
            mu1_v, dmu2_v = iso.data["X"][0], iso.data["Y"][:, 0]
            lr, wts = iso._bracket(dmu2_v, 2.5)
            srcs, metas = [hh._hist() for hh in hs], [hh._meta() for hh in hs]
            args = (srcs, metas, mu1_v, dmu2_v, lr, wts, beta, 1, CUTOFF)
            want, p_ms = once_ms(lambda: IB.iso_grid(*args, engine="torch"))
            w = compare_iso(got, want, f"capacity K3 {cname}")
            note(w)
            codes = torch.bincount(got[4].reshape(-1).long(), minlength=4).tolist()
            ok_share = codes[0] / (NX * NY)
            expect = codes[3] == NX * NY if P == 8 else (codes[0] == NX * NY if oname == "overflow31" else (codes[0] > 0 and codes[3] > 0 if P == 16 else ok_share > 0.5 and codes[3] == 0))
            if not expect:
                raise AssertionError(f"capacity K3 {cname}: fail codes {codes}")
            pro = IB._iso_prologue(srcs, metas[0], mu1_v, dmu2_v, lr, wts, beta, 1, CUTOFF)
            kin = [pro[k] for k in ("lnpi", "op", "xrows", "krows", "a", "edge", "mu", "lr", "wts", "tg", "volume")]
            k3 = lambda G=None, P=P, kin=kin: cuda_iso.iso_grid(*kin, mk3["smooth"], P, 1, CUTOFF, _lanes=G)  # noqa: E731
            N = srcs[0].nbins
            G = cuda_iso.lanes_per_cell(N, NX * NY, n_sm, P)
            k_ms = cuda_ms(k3)
            lane_ms = {}
            if P > 8:  # the wide build at each G against the plain version
                for Gf in launch.LANES:
                    wg = compare_iso(k3(Gf), want, f"capacity K3 {cname} G={Gf}")
                    note(wg)
                    lane_ms[Gf] = cuda_ms(lambda Gf=Gf: k3(Gf))
                    xm_areas[(oname, Gf)] = C.k3_layout("xm_bytes", Gf, len(srcs), NX, NY, N, 1, P)
            full_x, _ = IB._iso_surfaces(pro, slice(None), 1)
            ext = segment.relextrema(full_x, mk3["smooth"], P)
            lefts, rights, pmask = segment.phase_bounds(ext, full_x.shape[-1], P)
            del full_x, ext
            cov = {"left": lefts, "right": rights, "mask": pmask}
            ops = tail_ops(cov, NX * NY, N, mk3["smooth"], *k3_ops(1))
            b_ms, b_by = bound(kin, k3(), ops)
            m_ms = cuda_ms(lambda: iso.make_grid(*grid))
            cells[cname] = dict(NX=NX, NY=NY, B=NX * NY, N=N, order=1, max_phases=P, capacity=cuda_sweep.capacity(P), lanes=G,
                                staged_sources=C.k3_layout("staged_sources", G, len(srcs), NX, NY, N, 1, P), xm_bytes=C.k3_layout("xm_bytes", G, len(srcs), NX, NY, N, 1, P),
                                launches=launches, kernel_ms=k_ms, kernel_ms_by_lanes=lane_ms, plain_ms=p_ms, plain_ms_from="one run", make_grid_ms=m_ms,
                                bound_ms=b_ms, bound_by=b_by, ops=ops, covered_bins=covered_bins(cov, N), fail_codes=codes, worst=w)
            log(f"capacity K3 {cname}: N={N} {NY}x{NX} cells build cap={cuda_sweep.capacity(P)} G={G} x_m area {cells[cname]['xm_bytes']} B launches={launches} "
                f"fail codes {codes} | kernel {k_ms:.3f} ms" + "".join(f", G={Gf} {t:.3f} ms" for Gf, t in lane_ms.items()) + f" | "
                f"make_grid {m_ms:.3f} ms | plain {p_ms:.1f} ms (one run) | bound {b_ms:.4f} ms by {b_by} ({ops:.4g} f64 ops) | worst",
                json.dumps({k: float(f"{v:.3e}") for k, v in w.items()}), f"| {smi}")
    return xm_areas


def layouts_k3_wide(C, layout):
    """Phase 5f's layout lines of K3's wide build (the data behind the wide
    branch of cuda_iso.g1_switch): G = 1 against G = 32 at 16 and 64 slots
    on the overflow31 and overflow1400 sources over their windows, 31 and
    128 dMu_2 rows, from a few cells per SM up and at the capacity cells'
    grids; layout(key, N, B, P, time_g, rule, switch) times and logs one."""
    np, TC, dev = C.np, C.TC, C.dev
    cuda_iso, state, IB = C.cuda_iso, C.state, C.IB
    n_sm = C.cuda_sweep.sm_count(dev.index)
    for oname, NYl, per_sm in (("overflow31", 31, WIDE_PER_SM), ("overflow1400", 128, WIDE_PER_SM_1400)):
        ds, mk3, mu1_g, dmu2_g, beta = C.overflow_inputs(oname)
        iso = C.iso_cls([TC.port_histogram(dd, mk3, device=dev) for dd in ds], beta, order=1)
        srcs = [hh._hist() for hh in iso.data["histograms"]]
        N = srcs[0].nbins
        for NXl, NYr in sorted({(n_sm * k // NYl, NYl) for k in per_sm} | {(len(mu1_g), len(dmu2_g))}):
            mu1_v, dmu2_v = np.linspace(mu1_g[0], mu1_g[-1], NXl), np.linspace(dmu2_g[0], dmu2_g[-1], NYr)
            lr, wts = iso._bracket(dmu2_v, 2.5)
            for P in (16, 64):
                pro = IB._iso_prologue(srcs, state.HistMeta(**dict(mk3, max_phases=P)), mu1_v, dmu2_v, lr, wts, beta, 1, CUTOFF)
                kin = [pro[k] for k in ("lnpi", "op", "xrows", "krows", "a", "edge", "mu", "lr", "wts", "tg", "volume")]
                layout(f"K3 {oname} {NYr}x{NXl}", N, NXl * NYr, P, lambda G: cuda_iso.iso_grid(*kin, mk3["smooth"], P, 1, CUTOFF, _lanes=G),
                       cuda_iso.lanes_per_cell, cuda_iso.g1_switch(N, n_sm, P))


def capacity_phase(C, ptxas):
    """Phase 5f: the kernels' wide builds (64 phase slots; K1's 6 per-phase
    sums for nspec 3-4) through the entry points, each launch counter read
    just before the path and again just after, each run held against
    its plain version on the card (segmentation, K3's ok and fail_code
    equal; floats within 1e-10): K1 over multi573's 524,288 mu at 8, 16, 32
    and 64 slots and over tern573 / quat573 at 4 (None and janus); K2 over
    multi573's 4,096 mu x 64 targets at orders 1 and 2 and 16 and 64 slots,
    and its paired mode through one batched find_phase_eq_state at 16;
    make_grid on overflow31's 301 x 834 cells and overflow1400's 128 x 128
    at 8 slots (fail code 3) and at 16 and 64 (the sources' _meta raised),
    the bare K3 wrapper at G = 1 and 32, the x_m area its library reserves;
    layout lines at 16 and 64 slots.  Returns (record, {kernel: {cell:
    run}}, {kernel: worst abs diff}, {kernel: layout lines})."""
    torch, np, TC = C.torch, C.np, C.TC
    cuda_sweep, cuda_mb, cuda_iso, pipeline, segment, state, IB, launch = C.cuda_sweep, C.cuda_mb, C.cuda_iso, C.pipeline, C.segment, C.state, C.IB, C.launch
    from fhmcanalysis_torch.core import solve as SV

    dev, smi = C.dev, C.smi
    n_sm = cuda_sweep.sm_count(dev.index)
    t0 = time.perf_counter()
    K1, K2, K3 = cuda_sweep.NAME, cuda_mb.NAME, cuda_iso.NAME
    cells = {K1: {}, K2: {}, K3: {}}
    worst = {K1: 0.0, K2: 0.0, K3: 0.0}
    layouts = {K1: [], K2: [], K3: []}

    def note(kname, w):
        worst[kname] = max([worst[kname], *w.values()])

    def layout(kname, key, N, B, P, time_g, rule, switch):
        row = {G: cuda_ms(lambda G=G: time_g(G)) for G in launch.LANES}
        g = rule(N, B, n_sm, P)
        log(f"layout {key} P={P} B={B}: " + ", ".join(f"G={G} {t:.3f} ms" for G, t in row.items()) +
            f" | switch at B={switch}, rule G={g}: {row[g] / row[32 if g == 1 else 1]:.3f}x the time of G={32 if g == 1 else 1} | {smi}")
        layouts[kname].append(dict(key=key, max_phases=P, B=B, rule=g, ms=row))

    # ---- K1: multi573 at 8-64 slots, tern573 / quat573 (6 sums) ----
    k1_cases = [("multi573", P, None) for P in (8, 16, 32, 64)] + [(n, 4, c) for n in ("tern573", "quat573") for c in (None, "janus")]
    for name, P, collect in k1_cases:
        d, mk, mus_np = TC.capacity_cell(name, max_phases=P)
        h, meta = C.hist(d), state.HistMeta(**mk)
        mus = torch.as_tensor(mus_np, device=dev)
        B, N, S = mus.shape[0], h.nbins, meta.nspec
        cname = f"{name} P={P}" + (" janus" if collect else "")
        start_k1 = launch_count("k1")
        torch.cuda.reset_peak_memory_stats()
        out = pipeline.mu_sweep_thermo(h, meta, mus, props=True, collect=collect)
        torch.cuda.synchronize()
        launches = launch_count("k1") - start_k1
        k_peak = torch.cuda.max_memory_allocated() / 2**30
        if launches != 1:
            raise AssertionError(f"capacity {cname}: mu_sweep_thermo launched K1 {launches} times")
        if out["fe"].shape != (B, P) or out["n_i"].shape != (B, P, S):
            raise AssertionError(f"capacity {cname}: unexpected output shapes")
        torch.cuda.reset_peak_memory_stats()
        want, p_ms = once_ms(lambda: pipeline.mu_sweep_thermo(h, meta, mus, props=True, collect=collect, engine="torch"))
        p_peak = torch.cuda.max_memory_allocated() / 2**30
        w = compare(out, want, True, f"capacity {cname}")
        note(K1, w)
        del want
        share = float(out["valid"].double().mean())
        nph = torch.bincount(out["n_phases"][out["valid"]].long(), minlength=P + 1).nonzero()[:, 0].tolist()
        expect = {8: share == 0.0, 16: 0.0 < share < 1.0, 32: share == 1.0, 64: share == 1.0} if name == "multi573" else {4: share == 1.0 and nph == [1, 2]}
        if not expect[P]:
            raise AssertionError(f"capacity {cname}: valid share {share}, phase counts {nph}")
        a = pipeline._reweight_coeff(h, mus)
        keys = segment.key_rows(h.mom, meta).contiguous()
        k_ms = cuda_ms(lambda: cuda_sweep.sweep_thermo(h.lnpi, h.op, keys, h.volume, a, meta.smooth, P, True, collect))
        ops = tail_ops(out, B, N, meta.smooth, 2, 2 * (S + 1))
        b_ms, b_by = bound([h.lnpi, h.op, keys, h.volume, a], out.values(), ops)
        G = cuda_sweep.lanes_per_point(N, B, n_sm, P)
        cells[K1][cname] = dict(B=B, N=N, nspec=S, max_phases=P, capacity=cuda_sweep.capacity(P), sums=cuda_sweep.accumulators(S), lanes=G, launches=launches,
                                kernel_ms=k_ms, plain_ms=p_ms, plain_ms_from="one run", bound_ms=b_ms, bound_by=b_by, ops=ops, covered_bins=covered_bins(out),
                                valid_share=share, phases=nph, peak_gib=k_peak, plain_peak_gib=p_peak, worst=w)
        log(f"capacity K1 {cname}: N={N} nspec={S} B={B} build cap={cuda_sweep.capacity(P)} sums={cuda_sweep.accumulators(S)} G={G} launches={launches} valid share {share:.6f} "
            f"phases {nph[0] if nph else '-'}-{nph[-1] if nph else '-'} | kernel {k_ms:.3f} ms = {B / k_ms * 1e3:.4g} points/s (peak {k_peak:.2f} GiB) | "
            f"plain {p_ms:.1f} ms (one run, peak {p_peak:.2f} GiB) | bound {b_ms:.4f} ms by {b_by} ({ops:.4g} f64 ops) | worst", json.dumps({k: float(f"{v:.3e}") for k, v in w.items()}), f"| {smi}")
        del out

    # ---- K2: multi573, 4,096 mu x 64 targets, orders 1-2, 16 and 64 slots ----
    M, A = CAP_MB
    for P in (16, 64):
        d, mk, mus_np = TC.capacity_cell("multi573", M, max_order=3, max_phases=P)
        h, meta = C.hist(d), state.HistMeta(**mk)
        mus = torch.as_tensor(mus_np, device=dev)
        betas = d["curr_beta"] * np.linspace(0.98, 1.02, A)
        dmus = (d["curr_mu"][1:] - d["curr_mu"][0]) + np.linspace(-0.5, 0.5, A)[:, None]
        M, N, S = mus.shape[0], h.nbins, meta.nspec
        for order in (1, 2):
            cname = f"multi573 P={P} o{order}"
            start_k2, start_xa, start_tile = launch_count("k2"), launch_count("k2_xarea"), launch_count("k2_tile")
            torch.cuda.reset_peak_memory_stats()
            out = pipeline.mu_beta_sweep_thermo(h, meta, mus, betas, dmus, order=order, props=True)
            torch.cuda.synchronize()
            launches = launch_count("k2") - start_k2
            k_peak = torch.cuda.max_memory_allocated() / 2**30
            if launches != 1 or out["fe"].shape != (M, A, P):
                raise AssertionError(f"capacity K2 {cname}: {launches} launches, fe {tuple(out['fe'].shape)}")
            if launch_count("k2_xarea") != start_xa or launch_count("k2_tile") != start_tile:
                raise AssertionError(f"capacity K2 {cname}: N = {h.nbins} took the x' area or the target tile, which do not fit there")
            torch.cuda.reset_peak_memory_stats()
            want, p_ms = once_ms(lambda: pipeline.mu_beta_sweep_thermo(h, meta, mus, betas, dmus, order=order, props=True, engine="torch"))
            p_peak = torch.cuda.max_memory_allocated() / 2**30
            flat = lambda o: {k: v.reshape((-1,) + v.shape[2:]) for k, v in o.items()}  # noqa: E731
            w = compare(flat(out), flat(want), True, f"capacity K2 {cname}")
            note(K2, w)
            del want
            share = float(out["valid"].double().mean())
            if not (0.0 < share < 1.0 if P == 16 else share == 1.0):
                raise AssertionError(f"capacity K2 {cname}: valid share {share} (16 slots hold some points, 64 every point)")
            mu_t, a, xrows, krows, tg = pipeline._mb_inputs(h, meta, mus, betas, dmus, order, True, False)
            k2 = lambda G=None: cuda_mb.mb_sweep_thermo(h.lnpi, h.op, xrows, krows, h.volume, mu_t, a, tg, S, meta.smooth, P, order, True, _lanes=G)  # noqa: E731
            k_ms = cuda_ms(k2)
            x_ops, key_ops = k2_ops(S, order)
            ops = tail_ops(flat(out), M * A, N, meta.smooth, x_ops, key_ops)
            b_ms, b_by = bound([h.lnpi, h.op, xrows, krows, h.volume, mu_t, a, tg], out.values(), ops)
            G = cuda_mb.lanes_per_point(N, M * A, n_sm, P)
            cells[K2][cname] = dict(M=M, A=A, B=M * A, N=N, order=order, max_phases=P, capacity=cuda_sweep.capacity(P), lanes=G, launches=launches, kernel_ms=k_ms,
                                    plain_ms=p_ms, plain_ms_from="one run", bound_ms=b_ms, bound_by=b_by, ops=ops, covered_bins=covered_bins(flat(out)),
                                    valid_share=share, peak_gib=k_peak, plain_peak_gib=p_peak, worst=w)
            log(f"capacity K2 {cname}: N={N} M={M} A={A} B={M * A} build cap={cuda_sweep.capacity(P)} G={G} launches={launches} valid share {share:.6f} | "
                f"kernel {k_ms:.3f} ms = {M * A / k_ms * 1e3:.4g} points/s (peak {k_peak:.2f} GiB) | plain {p_ms:.1f} ms (one run, peak {p_peak:.2f} GiB) | "
                f"bound {b_ms:.4f} ms by {b_by} ({ops:.4g} f64 ops) | worst", json.dumps({k: float(f"{v:.3e}") for k, v in w.items()}), f"| {smi}")
            del out

    # ---- K2's paired mode: one batched find_phase_eq_state at 16 slots ----
    d, mk, _, kw = TC.coex31_guesses()
    mk = dict(mk, max_phases=16)
    h, meta = C.hist(d), state.HistMeta(**mk)
    betas = np.linspace(0.98, 1.02, 256)
    dmu = h.curr_mu[1:] - h.curr_mu[0]
    solve = lambda engine="auto": SV.find_phase_eq_state(h, meta, kw["lnZ_tol"], 5.6, beta=betas, dmu=dmu, order=1, min_width=kw["min_width"], extrapolate=True, engine=engine)  # noqa: E731
    start_k2 = launch_count("k2")
    (st, mus, err, conv), a_ms = once_ms(solve)
    launches = launch_count("k2") - start_k2
    (_, mus_p, err_p, conv_p), p_ms = once_ms(lambda: solve("torch"))
    d_mu = float((mus - mus_p).abs().max())
    if launches < 2 or not bool(conv.all()) or not torch.equal(conv, conv_p) or not d_mu <= 1e-9:
        raise AssertionError(f"capacity coex31 P=16: {launches} K2 launches, converged {int(conv.sum())}/256 (torch {int(conv_p.sum())}), mu_star apart by {d_mu:.3e}")
    objs = {e: SV._Objective(h, meta, torch.as_tensor(betas, device=dev), dmu[None].expand(256, -1), 1, kw["min_width"], True, None, e) for e in ("cuda", "torch")}
    obj = objs["cuda"]
    step_mu = mus.repeat(5) + torch.linspace(-1e-3, 1e-3, 5, device=dev, dtype=torch.float64).repeat_interleave(256)
    step_tix = torch.arange(256, dtype=torch.int32, device=dev).repeat(5)
    step_a = pipeline._reweight_coeff(h, step_mu).contiguous()
    paired = lambda: cuda_mb.mb_sweep_thermo(h.lnpi, h.op, obj.xrows, None, h.volume, step_mu, step_a, obj.tg, meta.nspec, meta.smooth, 16, 1, False, tix=step_tix)  # noqa: E731
    step_out = paired()
    want = objs["torch"].segment(step_mu, step_tix)
    w = compare(step_out, want, False, "capacity coex31 P=16 paired step")
    note(K2, w)
    s_ms = device_ms(paired, "mb_sweep_thermo_kernel") or cuda_ms(paired)
    ops = tail_ops(step_out, 1280, h.nbins, meta.smooth, k2_ops(meta.nspec, 1)[0], 0)
    b_ms, b_by = bound([h.lnpi, h.op, obj.xrows, h.volume, step_mu, step_a, obj.tg, step_tix], step_out.values(), ops)
    cells[K2]["coex31 P=16 paired step"] = dict(B=1280, N=h.nbins, paired=True, props=False, max_phases=16, capacity=cuda_sweep.capacity(16),
                                                 lanes=cuda_mb.lanes_per_point(h.nbins, 1280, n_sm, 16), launches=launches, kernel_ms=s_ms,
                                                 plain_ms=cuda_ms(lambda: objs["torch"].segment(step_mu, step_tix)),
                                                 bound_ms=b_ms, bound_by=b_by, ops=ops, solve_auto_ms=a_ms, solve_torch_ms=p_ms, d_mu_vs_torch=d_mu, worst=w)
    log(f"capacity coex31 P=16: find_phase_eq_state over 256 betas (extrapolating, K2 paired) K2 launches={launches} converged {int(conv.sum())}/256, "
        f"mu_star within {d_mu:.3e} of engine='torch' | solve (one run, the host building 256 states included) auto {a_ms:.2f} ms, torch {p_ms:.2f} ms | "
        f"one step (1,280 points) {s_ms:.4f} ms, bound {b_ms:.5f} ms by {b_by} | {smi}")

    xm_areas = capacity_k3(C, lambda w: note(K3, w), cells[K3])

    # ---- the wide builds' layout lines: G = 1 against G = 32 at 16 and 64
    # slots, from a few points per SM up (the data behind G1_PER_SM_CAP_WIDE) ----
    for name in ("ten31", "ripple121", "multi573"):
        for P in (16, 64):
            d, mk, mus_np = TC.capacity_cell(name, 2, max_order=3, max_phases=P)
            h, meta = C.hist(d), state.HistMeta(**mk)
            N, S = h.nbins, meta.nspec
            keys = segment.key_rows(h.mom, meta).contiguous()
            switch = n_sm * min(N, launch.G1_PER_SM_CAP_WIDE)
            betas = d["curr_beta"] * np.linspace(0.98, 1.02, A)
            dmus = (d["curr_mu"][1:] - d["curr_mu"][0]) + np.linspace(-0.5, 0.5, A)[:, None]
            counts = sorted({n_sm * k for k in WIDE_PER_SM} | ({TC.CAPACITY[name]["B"]} if name == "multi573" else set()))
            for B in counts:
                mus = torch.as_tensor(np.linspace(mus_np[0], mus_np[-1], B), device=dev)
                a = pipeline._reweight_coeff(h, mus)
                layout(K1, f"K1 {name} N={N}", N, B, P, lambda G: cuda_sweep.sweep_thermo(h.lnpi, h.op, keys, h.volume, a, meta.smooth, P, True, _lanes=G),
                       cuda_sweep.lanes_per_point, switch)
                Mk = max(1, B // A)
                sub = pipeline._mb_inputs(h, meta, mus[:: max(1, B // Mk)][:Mk].contiguous(), betas, dmus, 1, True, False)
                layout(K2, f"K2 {name} o1 M={Mk} A={A}", N, Mk * A, P, lambda G: cuda_mb.mb_sweep_thermo(
                    h.lnpi, h.op, sub[2], sub[3], h.volume, sub[0], sub[1], sub[4], S, meta.smooth, P, 1, True, _lanes=G), cuda_mb.lanes_per_point, switch)
    layouts_k3_wide(C, lambda *a: layout(K3, *a))
    # the wide builds' ptxas lines: each lane's stack (the compacted lists
    # at G = 1, the phases' bounds, maxima, fe and sums), spills, and the
    # static shared memory phase 2 held to the library's count; K3's build
    # with the x_m area also its dynamic area on the capacity cells that use
    # it
    builds = []
    mods = {cuda_sweep.NAME: cuda_sweep, cuda_mb.NAME: cuda_mb, cuda_iso.NAME: cuda_iso}
    for kname, rows in ptxas.items():
        for r in rows:
            if r["capacity"] == launch.CAPACITIES[-1]:
                counted = C.shared_bytes(mods[kname], r["lanes"], r["capacity"], r["kernel"])
                areas = {c: v for (c, G), v in xm_areas.items() if G == r["lanes"] and v} if r["kernel"].endswith(" xm") else {}
                builds.append(dict(r, library=kname, shared_bytes_counted=counted, xm_bytes=areas))
                log(f"capacity ptxas {r['kernel']} G={r['lanes']} cap={r['capacity']}" + (f" sums={r['sums']}" if r["sums"] else "") +
                    f": {r['registers']} registers, {r['stack']} bytes stack, {r['spill_stores']} bytes spill stores, {r['smem']} bytes smem "
                    f"(counted {counted})" + "".join(f"; x_m area {v} bytes dynamic on {c}" for c, v in areas.items()) + f" | {smi}")
    record = dict(seconds=time.perf_counter() - t0, cells={k: list(v) for k, v in cells.items()}, worst=worst, ptxas=builds)
    log(f"capacity phase: {record['seconds']:.1f} s, worst abs diff by kernel", json.dumps({k: float(f"{v:.3e}") for k, v in worst.items()}))
    return record, cells, worst, layouts


WORKFLOWS = ("square_well_phase_diagram", "binary_isopleth", "combining_simulations", "multivariable_extrapolation", "mutual_diffusion", "square_well_notebook")
# The workflows whose acceptance checks need the reference's data (not in
# the repository): the notebook's published values, and the 0.5 bar on
# multivariable_extrapolation's order-2 peak error, which the exact ideal
# gas misses at 1.12 (tests/test_torch_examples.py).
CHECK_WAITS = ("multivariable_extrapolation", "square_well_notebook")
PRODUCTION_DELTA = (0.005, 0.01)  # combining_simulations at 401 mu_1 x 501 dMu_2
GIBBS_DUHEM_TOL = 1e-8  # the production bar, for the Gibbs-Duhem isobars: splines through the contour amplify the surface's differences


def _same_values(got, want, tol, where, worst):
    """Two runs' result values (dicts, lists, tuples, arrays, scalars):
    integers, bools and non-finite entries equal, floats within tol
    relative to max(1, |want|); worst[where] gets the worst difference."""
    import numpy as np

    if isinstance(want, dict):
        if got.keys() != want.keys():
            raise AssertionError(f"{where}: keys {sorted(got)} != {sorted(want)}")
        for k in want:
            _same_values(got[k], want[k], GIBBS_DUHEM_TOL if k in ("errs", "ierrs", "isobars") else tol, f"{where}.{k}", worst)
    elif isinstance(want, (list, tuple)) and not all(isinstance(v, (int, float, np.number)) for v in want):
        if len(got) != len(want):
            raise AssertionError(f"{where}: {len(got)} entries != {len(want)}")
        for i, (x, y) in enumerate(zip(got, want)):
            _same_values(x, y, tol, f"{where}[{i}]", worst)
    elif want is None:
        if got is not None:
            raise AssertionError(f"{where}: a value where the reference run has none")
    else:
        g, w = np.asarray(got), np.asarray(want)
        if g.shape != w.shape:
            raise AssertionError(f"{where}: shape {g.shape} != {w.shape}")
        if w.dtype.kind in "biuO" or g.dtype.kind in "biuO":
            if not np.array_equal(g, w):
                raise AssertionError(f"{where}: differs (segmentation, validity or fail codes)")
            return
        fin = np.isfinite(w)
        if not np.array_equal(np.isfinite(g), fin) or not np.array_equal(g[~fin], w[~fin]):
            raise AssertionError(f"{where}: non-finite entries differ")
        d = float(np.max(np.abs(g[fin] - w[fin]) / np.maximum(1.0, np.abs(w[fin])), initial=0.0))
        worst[where] = d
        if not d <= tol:
            raise AssertionError(f"{where}: differs by {d:.3e} relative > {tol}")


def _states_loop(h, meta, mu_star, betas, dmus, order):
    """The T coexistence states one target at a time, stacked per field:
    find_phase_eq_state's batched extrapolating branch before it built
    them in one pass."""
    import dataclasses

    import torch

    from fhmcanalysis_torch.core import extrap, ops, state

    states = [extrap.temp_dmu_extrap(ops.reweight(h, mu_star[t]), meta, betas[t], dmus[t], order=order) for t in range(len(betas))]
    return state.Hist(**{f.name: torch.stack([getattr(o, f.name) for o in states]) for f in dataclasses.fields(state.Hist)})


def host_once(fn):
    """(fn(), its host-clock ms with the card synchronized before and after)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def workflows_phase(C):
    """Phase 5g: the reference-notebook workflows of examples/torch_*.py on
    the card with in-memory inputs (tests/torch_windows.example_inputs: no
    h5py here), each with the launch counters read just before its run
    and again just after, held against engine="torch" (the workflows on K2
    and K3) or, where the path has no kernel, the same run on the CPU;
    the batched phase-diagram solve at coex573 and coex31 P = 16 (256
    betas each): its states against the per-target loop and both times;
    combining_simulations at the production lattice against the closed
    form.  Returns (record, {kernel: {cell: ...}}, {kernel: worst})."""
    import importlib
    import tempfile

    torch, np, TC = C.torch, C.np, C.TC
    cuda_sweep, cuda_mb, cuda_iso, segment, state, IB, smi, dev = C.cuda_sweep, C.cuda_mb, C.cuda_iso, C.segment, C.state, C.IB, C.smi, C.dev
    import torch_windows as TW
    from fhmcanalysis_torch.core import extrap, ops
    from fhmcanalysis_torch.core import solve as SV

    sys.path.insert(0, os.path.join(ROOT, "examples"))
    import torch_example_io as ex

    names = {cuda_sweep.NAME: "k1", cuda_mb.NAME: "k2", cuda_iso.NAME: "k3"}
    cells = {n: {} for n in names}
    worst_k = {n: 0.0 for n in names}
    rec = {"workflows": {}, "batched_solve": {}, "production": {}}

    def counted(fn):
        start = {n: launch_count(k) for n, k in names.items()}
        out, ms = host_once(fn)
        return out, ms, {n: launch_count(k) - start[n] for n, k in names.items()}

    with tempfile.TemporaryDirectory(prefix="workflows_") as tmp:
        for name in WORKFLOWS:
            mod = importlib.import_module("torch_" + name)
            inputs = TW.example_inputs(name, tmp)
            got, ms, launches = counted(lambda: mod.run(inputs, dev))
            kernel_path = "engine" in inspect.signature(mod.run).parameters
            ref_what = 'engine="torch" on the card' if kernel_path else "the CPU"
            want = mod.run(inputs, dev, engine="torch") if kernel_path else mod.run(inputs, "cpu")
            worst = {}
            if name == "square_well_phase_diagram":
                d_mu = float(np.abs(got["mu_star"] - want["mu_star"]).max())
                if not d_mu <= 1e-9:
                    raise AssertionError(f"workflow {name}: mu_star differs from {ref_what} by {d_mu:.3e}")
                worst["mu_star"] = d_mu
                _same_values({k: v for k, v in got.items() if k != "mu_star"}, {k: v for k, v in want.items() if k != "mu_star"}, TOL, name, worst)
                if launches[cuda_mb.NAME] < 2:
                    raise AssertionError(f"workflow {name}: K2 launched {launches[cuda_mb.NAME]} times")
            elif name == "square_well_notebook":
                d_mu = abs(got["mu_kt"] - want["mu_kt"])
                if not d_mu <= 1e-9:
                    raise AssertionError(f"workflow {name}: mu*/kT differs from the CPU's by {d_mu:.3e}")
                worst["mu_kt"] = d_mu
                _same_values(dict(got, mu_kt=0.0), dict(want, mu_kt=0.0), TOL, name, worst)
                (_, _, fe1, _), (_, _, fe2, _) = got["rows"]
                if not got["is_safe"] or not abs(fe1 - fe2) < 1e-3:
                    raise AssertionError(f"workflow {name}: coexistence not found (is_safe {got['is_safe']}, fe {fe1}, {fe2})")
            else:
                _same_values(got, want, TOL, name, worst)
                if kernel_path and launches[cuda_iso.NAME] != 1:
                    raise AssertionError(f"workflow {name}: make_grid launched K3 {launches[cuda_iso.NAME]} times")
            if name in CHECK_WAITS:
                check = "waits for the reference's data"
            else:
                mod.check(got)
                check = "passed"
            rec["workflows"][name] = dict(launches=launches, run_ms=ms, against=ref_what, worst=max(worst.values(), default=0.0), check=check)
            for kname, n in launches.items():
                if n:
                    cells[kname]["workflow " + name] = dict(launches=n, run_ms=ms, worst=max(worst.values(), default=0.0))
                    worst_k[kname] = max(worst_k[kname], max(worst.values(), default=0.0))
            log(f"workflow {name}: run on the card {ms:.1f} ms (host clock), launches {launches} | against {ref_what}: segmentation and codes equal, "
                f"worst {max(worst.values(), default=0.0):.3e} | check {check} | {smi}")

    # ---- the batched phase-diagram solve at 256 betas: one pass against the per-target loop ----
    for cname in ("coex573", "coex31 P=16"):
        if cname == "coex573":
            d, mk, betas, guess, kw = TC.coex_grid()
            dmu = None
        else:
            d, mk, _, kw = TC.coex31_guesses()
            mk = dict(mk, max_phases=16)
            betas, guess, kw = np.linspace(0.98, 1.02, 256), 5.6, dict(kw, order=1)
            dmu = [-5.0]
        h, meta = C.hist(d), state.HistMeta(**mk)
        solve = lambda: SV.find_phase_eq_state(h, meta, kw["lnZ_tol"], guess, beta=betas, dmu=dmu, order=kw["order"], min_width=kw["min_width"], extrapolate=True)  # noqa: E731
        (out, mus, _, conv), total_ms, launches = counted(solve)
        if launches[cuda_mb.NAME] < 2 or out.lnpi.shape != (256, h.nbins) or out.mom.shape != (256,) + h.mom.shape:
            raise AssertionError(f"batched solve {cname}: K2 launches {launches[cuda_mb.NAME]}, states {tuple(out.lnpi.shape)}")
        tb, dmus = SV._targets(h, torch.as_tensor(betas, device=dev), None if dmu is None else torch.as_tensor(dmu, device=dev, dtype=torch.float64), 256)
        batch = lambda: extrap.temp_dmu_extrap(ops.reweight(h, mus), meta, tb, dmus, order=kw["order"])  # noqa: E731
        build_ms = [host_once(batch)[1] for _ in range(3)]
        loop, loop_ms = host_once(lambda: _states_loop(h, meta, mus, tb, dmus, kw["order"]))
        bits = torch.equal(out.lnpi, loop.lnpi) and torch.equal(out.mom, loop.mom)
        d_ln = float((out.lnpi - loop.lnpi).abs().max())
        d_mom = float(((out.mom - loop.mom).abs() / loop.mom.abs().clamp(min=1.0)).max())
        if not (d_ln <= 1e-12 and d_mom <= 1e-12 and torch.equal(out.curr_mu, loop.curr_mu) and torch.equal(out.curr_beta, loop.curr_beta)):
            raise AssertionError(f"batched solve {cname}: the batch's states differ from the per-target loop's (lnPI {d_ln:.3e}, moments {d_mom:.3e} relative)")
        (pt, props), thermo_ms = host_once(lambda: (lambda r: (r[1], segment.phase_props(r[1], out.volume)))(segment.thermo(out, meta)))
        _, pl = segment.thermo(loop, meta)
        for k in ("left", "right", "mask", "n_phases", "valid"):
            if not torch.equal(getattr(pt, k), getattr(pl, k)):
                raise AssertionError(f"batched solve {cname}: thermo of the batch segments differently from the loop's states ({k})")
        two = int(((pt.n_phases == 2) & pt.valid).sum())
        r = dict(T=256, N=h.nbins, max_phases=meta.max_phases, launches=launches, converged=int(conv.sum()), two_phase=two, solve_and_states_ms=total_ms,
                 states_ms=statistics.median(build_ms), states_loop_ms=loop_ms, thermo_ms=thermo_ms, bit_identical=bits, lnpi_abs=d_ln, mom_rel=d_mom)
        rec["batched_solve"][cname] = r
        cells[cuda_mb.NAME]["batched solve " + cname] = dict(launches=launches[cuda_mb.NAME], run_ms=total_ms, states_ms=r["states_ms"], states_loop_ms=loop_ms)
        log(f"batched solve {cname}: find_phase_eq_state(extrapolate=True) over 256 betas N={h.nbins} P={meta.max_phases}: {total_ms:.1f} ms (host clock, solve + states), "
            f"K2 launches {launches[cuda_mb.NAME]}, converged {int(conv.sum())}/256, two phases {two} | states in one pass {r['states_ms']:.2f} ms (median of 3) against "
            f"the per-target loop {loop_ms:.1f} ms; {'bit-identical' if bits else f'lnPI within {d_ln:.3e}, moments {d_mom:.3e} relative'} | thermo + phase_props of the batch "
            f"{thermo_ms:.2f} ms | {smi}")

    # ---- combining_simulations at a production lattice: K3 at full width ----
    mod = importlib.import_module("torch_combining_simulations")
    inputs = TC.ideal_gas_sources(1.20)
    res, ms, launches = counted(lambda: mod.run(inputs, dev, delta=PRODUCTION_DELTA))
    NY, NX = res["Z"].shape
    share = float(res["valid"].mean())
    if (NY, NX) != (501, 401) or launches[cuda_iso.NAME] != 1 or share <= 0.7:
        raise AssertionError(f"production lattice: grid {(NY, NX)}, K3 launches {launches[cuda_iso.NAME]}, valid share {share:.4f}")
    x1_max, p_max = float(res["x1_err"].max()), float(res["p_rel"].max())
    if not (x1_max < 0.02 and p_max < 0.02):
        raise AssertionError(f"production lattice: against the closed form x1 {x1_max:.3e}, P {p_max:.3e} relative (bar 0.02)")
    # K3 alone on the lattice, against its plain version, and its bound
    hs = [ex.load(src, 1.0 / 1.20, [0.0, dm], 10, dev) for dm, src in ex.dmu2_sources(inputs).items()]
    iso = C.iso_cls(hs, 1.0 / 1.10, order=2)
    mu1_v, dmu2_v = iso._grids((-6.0, -4.0), (-2.5, 2.5), PRODUCTION_DELTA)
    lr, wts = iso._bracket(dmu2_v, 2.5)
    srcs, metas = [hh._hist() for hh in hs], [hh._meta() for hh in hs]
    pro = IB._iso_prologue(srcs, metas[0], mu1_v, dmu2_v, lr, wts, 1.0 / 1.10, 2, CUTOFF)
    kin = [pro[k] for k in ("lnpi", "op", "xrows", "krows", "a", "edge", "mu", "lr", "wts", "tg", "volume")]
    k3 = lambda: cuda_iso.iso_grid(*kin, 10, 8, 2, CUTOFF)  # noqa: E731
    got = k3()
    want, p_ms = once_ms(lambda: IB.iso_grid(srcs, metas, mu1_v, dmu2_v, lr, wts, 1.0 / 1.10, 2, CUTOFF, engine="torch"))
    w = compare_iso(got, want, "production lattice K3 vs plain", min_ok=0.7)
    k_ms = device_ms(k3, "iso_grid") or cuda_ms(k3)
    full_x, _ = IB._iso_surfaces(pro, slice(None), 2)
    ext = segment.relextrema(full_x, 10, 8)
    lefts, rights, pmask = segment.phase_bounds(ext, full_x.shape[-1], 8)
    cov = {"left": lefts, "right": rights, "mask": pmask}
    del full_x, ext
    x_ops, key_ops = k3_ops(2)
    ops_n = tail_ops(cov, NY * NX, srcs[0].nbins, 10, x_ops, key_ops)
    b_ms, b_by = bound(kin, got, ops_n)
    worst_k[cuda_iso.NAME] = max(worst_k[cuda_iso.NAME], *w.values())
    rec["production"] = dict(NY=NY, NX=NX, cells=NY * NX, N=srcs[0].nbins, order=2, run_ms=ms, launches=launches, valid_share=share, x1_err=x1_max, p_rel=p_max,
                             kernel_ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by, worst=w)
    cells[cuda_iso.NAME]["combining production lattice"] = dict(NY=NY, NX=NX, B=NY * NX, N=srcs[0].nbins, order=2, lanes=cuda_iso.lanes_per_cell(srcs[0].nbins, NY * NX, cuda_sweep.sm_count(dev.index)),
                                                                launches=launches[cuda_iso.NAME], kernel_ms=k_ms, plain_ms=p_ms, run_ms=ms, bound_ms=b_ms, bound_by=b_by, ops=ops_n, worst=w)
    log(f"production lattice combining_simulations: {NY} dMu_2 x {NX} mu_1 = {NY * NX} cells, N={srcs[0].nbins}, order 2: run {ms:.1f} ms (host clock), K3 launches "
        f"{launches[cuda_iso.NAME]}, valid share {share:.4f}, against the closed form x1 within {x1_max:.3e}, P within {p_max:.3e} relative | K3 {k_ms:.3f} ms, plain {p_ms:.1f} ms "
        f"(one run), bound {b_ms:.4f} ms by {b_by} | K3 vs plain worst {max(w.values()):.3e} | {smi}")
    return rec, cells, worst_k


ROW_ARITH = ("aten::add", "aten::sub", "aten::mul", "aten::div", "aten::neg", "aten::reciprocal", "aten::pow", "aten::rsub")


def rows_read(t):
    """The flat moment rows the row former reads under its table t, walked
    through the gates of form_bin (csrc/mb_rows.cuh): a zero-power entry,
    a padded slot, a KE term without ke and a row behind a closed gate
    read nothing."""
    S, rows = t.S, set()

    def sgb(r):
        if not r.zero:
            rows.update((r.b, r.bu, *r.xni[:S], *t.key[: S + 1]))
            if r.ke:
                rows.add(r.bd)

    def sgm(r):
        if not r.zero:
            rows.update((r.b, r.xni, t.key[1]))

    sg1 = t.props and t.gate1
    if t.order >= 2 or sg1:
        for k in range(S + 1):
            sgb(t.slot[k].a)
    if S == 2 and sg1:
        for k in range(S + 1):
            sgm(t.slot[k].ma)
    rows.update(t.key[1 : S + 1])  # r1, mq
    if t.order >= 2 and S == 2:
        rows.update(t.f11)  # h11
    if t.props:
        rows.update(t.key[: S + 1])  # the key rows themselves
        if t.khess and t.gate2:
            for k in range(S + 1):
                sl = t.slot[k]
                rows.add(sl.m)
                sgb(sl.au)
                for i in range(S):
                    sgb(sl.an[i])
                if sl.a.ke:
                    rows.add(sl.a.bd)
                    sgb(sl.ad)
                if S == 2:
                    rows.add(sl.pn)
                    sgb(sl.pnb)
                    sgm(sl.mn)
    return rows


def row_former_phase(C, ptxas):
    """The row former (cuda_mb.mb_rows, csrc/mb_rows.cuh, in K2's library)
    against the plain pipeline._mb_rows on the card, bit for bit, over the
    test grid at N = 31 (n31), 573 (n573) and 1400 (n1400); then at order 2
    with props on each cell: its device time (profiler, mean of 20
    launches), its call on the host's clock (wrapper and launch,
    synchronised), the plain version's call, and its bound.  The bound's
    bytes are the distinct moment rows it reads (rows_read), op and the
    rows written; its operations one per bin for each arithmetic torch
    operation of the plain version over the bins (a profile of it).
    Returns its kernels-line entry without "launches": phase 4's main
    paths count those."""
    torch, TC, cuda_mb, pipeline, state = C.torch, C.TC, C.cuda_mb, C.pipeline, C.state
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    n_cases = n_launch = 0
    for cname in ("n31", "n573", "n1400"):
        for max_order in TC.ROW_MAX_ORDERS:
            for used_ke in (False, True):
                xs, mk = TC.row_inputs(cname, max_order, used_ke)
                meta = state.HistMeta(**mk)
                for x in xs:
                    h = C.hist(x)
                    for order, props, fom in TC.ROW_CASES:
                        where = f"row former {cname} max_order={max_order} ke={used_ke} order={order} props={props} fom={fom}"
                        try:
                            want = pipeline._mb_rows(h, meta, order, props, fom)
                        except (ValueError, IndexError) as e:
                            try:
                                cuda_mb.mb_rows(h, meta, order, props, fom)
                            except type(e):
                                continue
                            raise AssertionError(f"{where}: the plain version raises {e!r}, the row former does not")
                        got = cuda_mb.mb_rows(h, meta, order, props, fom)
                        n_launch += 1
                        for g, w, what in ((got[0], want[0], "xrows"), (got[1], want[1], "krows")):
                            if (g is None) != (w is None) or (g is not None and not torch.equal(g.view(torch.int64), w.view(torch.int64))):
                                raise AssertionError(f"{where}: {what} differ from the plain version's")
                        n_cases += 1
    log(f"parity row former: {n_cases} cases bit for bit equal to pipeline._mb_rows ({n_launch} launches) in {time.perf_counter() - t0:.1f} s")

    cells = {}
    for cname in ("n31", "n573", "n1400"):
        d, mk, _ = TC.cell(cname, 8, max_order=3)
        h, meta = C.hist(d), state.HistMeta(**mk)
        S, N = meta.nspec, h.nbins

        def former():
            return cuda_mb.mb_rows(h, meta, 2, True, False)

        def plain():
            return pipeline._mb_rows(h, meta, 2, True, False)

        def synced(fn):
            return lambda: (fn(), torch.cuda.synchronize())

        k_ms = device_ms(former, "mb_rows_kernel")
        call_ms, plain_ms = host_ms(synced(former), reps=20), host_ms(synced(plain), reps=5)
        with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
            plain()
        ops = N * sum(1 for e in prof.events() if e.name in ROW_ARITH and any(sh and sh[-1] == N for sh in e.input_shapes))
        rows = rows_read(cuda_mb.rows_table(meta, 2, True, False))
        xrows, krows = former()
        read = torch.empty((len(rows) + 1, N), dtype=torch.float64, device=h.lnpi.device)  # the moment rows and op, by size only
        b_ms, b_by = bound([read, h.curr_beta, h.curr_mu], [xrows, krows], ops)
        cells[cname] = dict(N=N, S=S, order=2, kernel_ms=k_ms, call_ms=call_ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, ops=ops, moment_rows=len(rows))
        log(f"row former {cname}: N={N} S={S} order 2, props | kernel {k_ms:.4f} ms (device) | call {call_ms:.4f} ms (host clock, synchronised) | "
            f"plain _mb_rows {plain_ms:.3f} ms ({ops // N} arithmetic ops over the bins) | bound {b_ms:.6f} ms by {b_by} ({len(rows)} moment rows) | {C.smi}")
    return {
        "name": "mb_rows",
        "route": "cuda",
        "source": "fhmcanalysis_torch/csrc/mb_rows.cuh (built into mb_sweep_thermo.cu's library)",
        "replaces": None,  # no TPU kernel: the JAX package forms these rows with jnp operations in its jitted sweep
        "parity_launches": n_launch,
        "max_abs_err": 0.0,
        "ms": cells["n31"]["kernel_ms"],
        "plain_ms": cells["n31"]["plain_ms"],
        "bound_ms": cells["n31"]["bound_ms"],
        "bound_by": cells["n31"]["bound_by"],
        "library_ms": None,
        "cells": cells,
        "ptxas": [r for r in ptxas[cuda_mb.NAME] if r["kernel"] == "mb_rows_kernel"],
    }


def run():
    C = Ctx()
    torch, np, TC = C.torch, C.np, C.TC
    cuda_sweep, cuda_mb, cuda_iso, pipeline, segment, state, IB = C.cuda_sweep, C.cuda_mb, C.cuda_iso, C.pipeline, C.segment, C.state, C.IB
    dev, smi, hist = C.dev, C.smi, C.hist
    LANES = C.launch.LANES
    n_sm = cuda_sweep.sm_count(dev.index)

    # ---- 2. build ----
    ptxas = C.build()

    # ---- 3. kernel vs plain on the card ----
    worst: dict = {}
    worst_mb: dict = {}
    worst_lanes = {G: 0.0 for G in LANES}  # K1 and K2 at each forced G, every field

    def note(w, into=worst, G=None):
        for k, v in w.items():
            into[k] = max(into.get(k, 0.0), v)
            if G is not None:
                worst_lanes[G] = max(worst_lanes[G], v)

    def k1_all(h, meta, mus, props, collect, where):
        """K1 at the rule's G and at every G against one plain run."""
        want = pipeline.mu_sweep_thermo(h, meta, mus, props=props, collect=collect, engine="torch")
        got = pipeline.mu_sweep_thermo(h, meta, mus, props=props, collect=collect, engine="cuda")
        torch.cuda.synchronize()
        note(compare(got, want, props, where))
        for G in LANES:
            got = pipeline.mu_sweep_thermo(h, meta, mus, props=props, collect=collect, engine="cuda", _lanes=G)
            torch.cuda.synchronize()
            note(compare(got, want, props, f"{where} G={G}"), G=G)

    for cname in TC.CELLS:
        d, mk, mus = TC.cell(cname, 4096)
        h, meta = hist(d), state.HistMeta(**mk)
        for props in (True, False):
            for collect in (None, "janus"):
                k1_all(h, meta, mus, props, collect, f"{cname} props={props} collect={collect}")
    d31, mk31, _ = TC.cell("n31")
    for kind in TC.SURFACE_KINDS:
        rng = np.random.default_rng(TC.SURFACE_KINDS.index(kind))
        for smooth in (1, 2):
            for _ in range(4):
                h = hist(dict(d31, lnpi=TC.random_surface(kind, 31, rng)))
                meta = state.HistMeta(**dict(mk31, smooth=smooth, max_phases=8))
                k1_all(h, meta, np.linspace(4.85, 5.15, 256), True, None, f"{kind} smooth={smooth}")
    d14, mk14, _ = TC.cell("n1400")
    for i, y in enumerate(TC.janus_surfaces(1400)):
        k1_all(hist(dict(d14, lnpi=10.0 * y)), state.HistMeta(**mk14), np.linspace(4.99, 5.01, 512), True, "janus", f"janus surface {i}")
    # the shuffled grid: every warp mixes segmentation cases; 4,099 points
    # leave a partial block and a partial warp at every G
    shuffled = TC.shuffled_mu_grid(4099)
    for surface, lnpi in (("n31", d31["lnpi"]), ("negated", -d31["lnpi"])):
        for props in (True, False):
            for collect in (None, "janus"):
                k1_all(hist(dict(d31, lnpi=lnpi)), state.HistMeta(**mk31), shuffled, props, collect, f"shuffled {surface} props={props} collect={collect}")
    log("parity K1: kernel vs plain (rule's G and G in", LANES, "), worst abs diff on valid masked slots:", json.dumps({k: float(f"{v:.3e}") for k, v in worst.items()}))

    # K2 over its coverage: 512 mu x 8 targets = 4,096 points per case
    def mb_case(cname, used_ke=False, mus=None):
        d, mk, mus0 = TC.cell(cname, 512, max_order=3, used_ke=used_ke)
        dref = d["curr_mu"][1:] - d["curr_mu"][0]
        dmus = dref + np.linspace(-0.5, 0.5, 8)[:, None] if mk["nspec"] == 2 else np.zeros((1, 0))
        return d, hist(d), state.HistMeta(**mk), mus0 if mus is None else mus, np.linspace(0.92, 1.08, 8), dmus

    def mb_flat(o):
        return {k: v.reshape((-1,) + v.shape[2:]) for k, v in o.items()}

    def k2_all(h, meta, mus, betas, dmus, where, **kw):
        """K2 at the rule's G and at every G against one plain run."""
        want = mb_flat(pipeline.mu_beta_sweep_thermo(h, meta, mus, betas, dmus, engine="torch", **kw))
        got = pipeline.mu_beta_sweep_thermo(h, meta, mus, betas, dmus, engine="cuda", **kw)
        torch.cuda.synchronize()
        note(compare(mb_flat(got), want, kw["props"], where), worst_mb)
        for G in LANES:
            got = pipeline.mu_beta_sweep_thermo(h, meta, mus, betas, dmus, engine="cuda", _lanes=G, **kw)
            torch.cuda.synchronize()
            note(compare(mb_flat(got), want, kw["props"], f"{where} G={G}"), worst_mb, G=G)

    n_cases = 0
    for cname in TC.CELLS:
        for used_ke in (False, True) if cname == "n31" else (False,):
            d, h, meta, mus, betas, dmus = mb_case(cname, used_ke)
            for order in (1, 2):
                for props in (True, False):
                    for collect in (None, "janus"):
                        for fom in (False, True) if order == 2 and props else (False,):
                            kw = dict(order=order, props=props, first_order_mom=fom, collect=collect)
                            k2_all(h, meta, mus, betas, dmus, f"K2 {cname} ke={used_ke} {kw}", **kw)
                            n_cases += 1
            # identity targets: K2 must return K1's output bit for bit at every G
            ref = (h.curr_mu[1:] - h.curr_mu[0]).cpu().numpy()[None]
            for G in (None,) + LANES:
                for order in (1, 2):
                    for props in (True, False):
                        for collect in (None, "janus"):
                            k2 = pipeline.mu_beta_sweep_thermo(h, meta, mus, h.curr_beta.reshape(1).cpu().numpy(), ref, order=order, props=props, collect=collect, engine="cuda", _lanes=G)
                            k1 = pipeline.mu_sweep_thermo(h, meta, mus, props=props, collect=collect, engine="cuda", _lanes=G)
                            torch.cuda.synchronize()
                            for k in k1:
                                if not torch.equal(k2[k][:, 0], k1[k]):
                                    raise AssertionError(f"K2 at identity targets differs from K1 in {k} ({cname} G={G} order={order} props={props} collect={collect})")
    # the shuffled grid: 515 mu x 8 targets = 4,120 points, partial blocks at every G
    for surface, sign in (("n31", 1.0), ("negated", -1.0)):
        d, _, meta, _, betas, dmus = mb_case("n31")
        h = hist(dict(d, lnpi=sign * d["lnpi"]))
        for order in (1, 2):
            for collect in (None, "janus"):
                kw = dict(order=order, props=True, first_order_mom=False, collect=collect)
                k2_all(h, meta, TC.shuffled_mu_grid(515, seed=2), betas, dmus, f"K2 shuffled {surface} {kw}", **kw)
                n_cases += 1
    log(f"parity K2: {n_cases} cases vs plain (rule's G and G in {LANES}), worst abs diff on valid masked slots:", json.dumps({k: float(f"{v:.3e}") for k, v in worst_mb.items()}))
    log(f"parity K2: identity targets equal K1 bit for bit on every field at the rule's G and G in {LANES}")
    log("parity K1+K2 by forced G, worst abs diff over every float field:", json.dumps({G: float(f"{v:.3e}") for G, v in worst_lanes.items()}))

    # K2's paired mode (the coexistence solver's): the product mode's point
    # (m, tix[m]) bit for bit at each G -- the diagonal of a 64 x 64 product
    # and random targets of a 4,096 x 64 one -- and the plain version at the
    # rule's G and at each G
    n_paired = 0
    for cname in ("n31", "n573"):
        d, mk, mus = TC.cell(cname, 4096, max_order=3)
        h, meta = hist(d), state.HistMeta(**mk)
        A = 64
        dmus = (d["curr_mu"][1:] - d["curr_mu"][0]) + np.linspace(-0.4, 0.4, A)[:, None] if mk["nspec"] == 2 else np.zeros((1, 0))
        rng = np.random.default_rng(len(cname))
        for order in (1, 2):
            for props in (True, False):
                mu, a, xrows, krows, tg = pipeline._mb_inputs(h, meta, mus, np.linspace(0.92, 1.08, A), dmus, order, props, False)
                for collect in (None, "janus"):
                    def k2(M, **kw):
                        return cuda_mb.mb_sweep_thermo(h.lnpi, h.op, xrows, krows if props else None, h.volume, mu[:M], a[:M], tg, meta.nspec, meta.smooth, meta.max_phases,
                                                       order, props, False, collect, **kw)

                    where = f"K2 paired {cname} order={order} props={props} collect={collect}"
                    for M, tix_np in ((A, np.arange(A)), (4096, rng.integers(0, A, size=4096))):
                        tix = torch.as_tensor(tix_np, dtype=torch.int32, device=dev)
                        rows = torch.arange(M, device=dev) * A + tix.long()
                        for G in LANES:
                            prod, got = k2(M, _lanes=G), k2(M, tix=tix, _lanes=G)
                            torch.cuda.synchronize()
                            for k in prod:
                                if not torch.equal(got[k], prod[k][rows]):
                                    raise AssertionError(f"{where} M={M} G={G}: {k} differs from the product mode's (m, tix[m])")
                    want = pipeline._mb_paired_body(h, meta, mu, a, xrows, krows, tg, tix, order, props, collect)
                    for G in (None,) + LANES:
                        got = k2(4096, tix=tix, _lanes=G)
                        torch.cuda.synchronize()
                        note(compare(got, want, props, f"{where} G={G}"), worst_mb, G=G)
                    n_paired += 1
    log(f"parity K2 paired: {n_paired} cases equal the product mode's (m, tix[m]) bit for bit on every field at G in {LANES}; "
        "against the plain version (rule's G and every G) the worst abs diff so far:", json.dumps({k: float(f"{v:.3e}") for k, v in worst_mb.items()}))
    # the kernel's own range guard: entries written past the wrapper's check
    # (through .data, which the version counter does not see) come back as
    # invalid points, and every other point is unchanged
    mu, a, xrows, krows, tg = pipeline._mb_inputs(h, meta, mus, np.linspace(0.92, 1.08, A), dmus, 1, True, False)
    n_hit = 0
    for G in LANES:
        tix = torch.as_tensor(rng.integers(0, A, size=4096), dtype=torch.int32, device=dev)

        def k2_guard():
            return cuda_mb.mb_sweep_thermo(h.lnpi, h.op, xrows, krows, h.volume, mu, a, tg, meta.nspec, meta.smooth, meta.max_phases, 1, True, False, None, tix=tix, _lanes=G)

        before = tix._version
        want = k2_guard()
        tix.data[::7], tix.data[3::7] = A, -1
        if tix._version != before:
            raise AssertionError("K2 guard: the write through .data moved the version counter; the case tests nothing")
        got = k2_guard()
        torch.cuda.synchronize()
        hit = (tix < 0) | (tix >= A)
        n_hit = int(hit.sum())
        floats = ("fe", "n_i", "x_i", "ntot", "u", "density")
        if bool(got["valid"][hit].any()) or bool(got["n_phases"][hit].any()) or bool(got["mask"][hit].any()) or not all(bool(got[k][hit].isnan().all()) for k in floats):
            raise AssertionError(f"K2 guard G={G}: a point with tix out of range is not marked invalid")
        for k in got:
            if not torch.equal(got[k][~hit], want[k][~hit]):
                raise AssertionError(f"K2 guard G={G}: {k} of an in-range point changed")
    log(f"parity K2 paired guard: {n_hit} of 4096 points with tix out of range (written past the wrapper's check) come back invalid with NaN floats at G in {LANES}; the rest unchanged")

    # the row former: K2's rows in one launch, bit for bit the plain version's
    row_former = row_former_phase(C, ptxas)

    # K3 over its coverage: <= 64 x 64 = 4,096 cells per case, at the rule's G and at every G
    worst_iso: dict = {}
    worst_iso_lanes = {G: 0.0 for G in LANES}
    cases = k3_cases(np, TC)
    for kw in cases:
        min_ok = kw.pop("min_ok", 0.3)
        args = C.iso_args(**kw)
        want = IB.iso_grid(*args, engine="torch")
        for G in (None,) + LANES:
            got = IB.iso_grid(*args, engine="cuda", _lanes=G)
            torch.cuda.synchronize()
            w = compare_iso(got, want, f"K3 {kw} G={G}", min_ok)
            note(w, worst_iso)
            if G is not None:
                worst_iso_lanes[G] = max([worst_iso_lanes[G], *w.values()])
    log(f"parity K3: {len(cases)} cases vs plain (rule's G and G in {LANES}), ok and fail_code equal, worst abs diff on ok cells:",
        json.dumps({k: float(f"{v:.3e}") for k, v in worst_iso.items()}), "| by forced G:", json.dumps({G: float(f"{v:.3e}") for G, v in worst_iso_lanes.items()}))

    # ---- 4. main paths ----
    runs = {}
    for cname in MAIN_CELLS:
        d, mk, mus_np = TC.cell(cname)
        h, meta = hist(d), state.HistMeta(**mk)
        mus = torch.as_tensor(mus_np, device=dev)
        start_k1 = launch_count("k1")
        out = pipeline.mu_sweep_thermo(h, meta, mus, props=True)
        torch.cuda.synchronize()
        launches = launch_count("k1") - start_k1
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
        ops = tail_ops(out, B, h.nbins, meta.smooth, 2, 2 * (meta.nspec + 1))
        b_ms, b_by = bound([h.lnpi, h.op, keys, h.volume, a], out.values(), ops)
        runs[cname] = dict(B=B, N=h.nbins, lanes=cuda_sweep.lanes_per_point(h.nbins, B, n_sm), launches=launches, kernel_ms=k_ms, plain_ms=p_ms, auto_ms=e_ms, phases=nph[1:3],
                           bound_ms=b_ms, bound_by=b_by, ops=ops, covered_bins=covered_bins(out))
        log(
            f"main path {cname}: N={h.nbins} B={B} G={runs[cname]['lanes']} launches={launches} phases(1,2)={nph[1:3]} | "
            f"kernel {k_ms:.3f} ms = {B / k_ms * 1e3:.4g} points/s | mu_sweep_thermo auto {e_ms:.3f} ms = {B / e_ms * 1e3:.4g} points/s | "
            f"plain {p_ms:.3f} ms = {B / p_ms * 1e3:.4g} points/s (peak {peak:.2f} GiB) | bound {b_ms:.4f} ms by {b_by} ({ops:.4g} f64 ops) | {smi}"
        )

    mb_runs, rows_main, xarea_main, tile_main = {}, {}, {}, {}  # the row former's launches, and K2's that took the x' area and the target tile, on each main path
    d, mk, mus_np, betas, dmus = TC.mb_grid()
    h, meta = hist(d), state.HistMeta(**mk)
    mus = torch.as_tensor(mus_np, device=dev)
    M, A = mus.shape[0], betas.shape[0]
    for order in MB_ORDERS:
        cname = f"mb31_o{order}"
        start_k2, start_rows, start_xa, start_tile = launch_count("k2"), launch_count("mb_rows"), launch_count("k2_xarea"), launch_count("k2_tile")
        out = pipeline.mu_beta_sweep_thermo(h, meta, mus, betas, dmus, order=order, props=True)
        torch.cuda.synchronize()
        launches, rows_main[cname] = launch_count("k2") - start_k2, launch_count("mb_rows") - start_rows
        if launches < 1:
            raise AssertionError(f"{cname}: the main path launched K2 {launches} times")
        if rows_main[cname] != 1:
            raise AssertionError(f"{cname}: the main path launched the row former {rows_main[cname]} times (one a call)")
        xarea_main[cname] = launch_count("k2_xarea") - start_xa
        if xarea_main[cname] != launches:
            raise AssertionError(f"{cname}: {xarea_main[cname]} of the main path's {launches} K2 launches formed x' into the area (all of them should)")
        tile_main[cname] = launch_count("k2_tile") - start_tile
        if tile_main[cname] != launches:
            raise AssertionError(f"{cname}: {tile_main[cname]} of the main path's {launches} K2 launches took the target tile (all of them should)")
        if out["fe"].shape != (M, A, meta.max_phases) or out["x_i"].shape != (M, A, meta.max_phases, meta.nspec):
            raise AssertionError(f"{cname}: unexpected output shapes")
        valid = out["valid"]
        nph = torch.bincount(out["n_phases"][valid].long(), minlength=3).tolist()
        if nph[1] == 0 or nph[2] == 0:
            raise AssertionError(f"{cname}: phase counts over valid points {nph}: both one- and two-phase points must occur")
        real = out["mask"] & valid[..., None]
        if not bool(torch.isfinite(out["fe"][real]).all()) or not bool(torch.isfinite(out["n_i"][real]).all()):
            raise AssertionError(f"{cname}: non-finite result on a real phase of a valid point")
        share = float(valid.double().mean())
        midx = torch.as_tensor(np.sort(np.random.default_rng(order).choice(M, 4096 // A, replace=False)), device=dev)
        ref = pipeline.mu_beta_sweep_thermo(h, meta, mus[midx], betas, dmus, order=order, props=True, engine="torch")
        note(compare(mb_flat({k: v[midx] for k, v in out.items()}), mb_flat(ref), True, f"{cname} main path sample"), worst_mb)

        args = pipeline._mb_inputs(h, meta, mus, betas, dmus, order, True, False)
        mu_t, a, xrows, krows, tg = args

        def k2():
            return cuda_mb.mb_sweep_thermo(h.lnpi, h.op, xrows, krows, h.volume, mu_t, a, tg, meta.nspec, meta.smooth, meta.max_phases, order, True)

        k_ms = cuda_ms(k2)
        torch.cuda.reset_peak_memory_stats()
        p_ms = cuda_ms(lambda: pipeline.mu_beta_sweep_thermo(h, meta, mus, betas, dmus, order=order, props=True, engine="torch"))
        peak = torch.cuda.max_memory_allocated() / 2**30
        e_ms = cuda_ms(lambda: pipeline.mu_beta_sweep_thermo(h, meta, mus, betas, dmus, order=order, props=True))
        B, S = M * A, meta.nspec
        # as extrap_rows.cuh forms them: reweight, dB term, dd term, order-2 terms (3 products, 2 sums, the half)
        x_ops = 2 + 4 + 2 + (7 if order == 2 else 0)
        key_ops = (S + 1) * (2 + 2 + 2 + (7 if order == 2 else 0))  # key' per row (dB, dd, order-2 terms), then its multiply-add
        ops = tail_ops(mb_flat(out), B, h.nbins, meta.smooth, x_ops, key_ops)
        b_ms, b_by = bound([h.lnpi, h.op, xrows, krows, h.volume, mu_t, a, tg], out.values(), ops)
        # blocks an SM of the build the main path ran (the tiled one) and of the untiled area's and the re-forming build's
        lib = cuda_mb._lib()
        occ = [lib.mb_sweep_thermo_blocks_per_sm(0, 1, 8, x, p, h.nbins, S, order, 1, 0, M, A) for x, p in ((-1, 0), (-1, 1), (0, 0))]
        log(f"{cname}: blocks an SM at N = {h.nbins}: target tile {occ[0]}, untiled x' area {occ[1]}, re-form {occ[2]} (K2 at G = 1, 8 slots)")
        if occ[0] < 8:
            raise AssertionError(f"{cname}: the tiled build holds {occ[0]} blocks an SM, fewer than the 8 its rule counts")
        mb_runs[cname] = dict(M=M, A=A, B=B, N=h.nbins, order=order, lanes=cuda_mb.lanes_per_point(h.nbins, M * A, n_sm), launches=launches, xarea_launches=xarea_main[cname],
                              tile_launches=tile_main[cname], blocks_per_sm=dict(tile=occ[0], xarea=occ[1], reform=occ[2]), kernel_ms=k_ms, plain_ms=p_ms, auto_ms=e_ms,
                              phases=nph[1:3], valid_share=share, bound_ms=b_ms, bound_by=b_by, ops=ops, covered_bins=covered_bins(mb_flat(out)))
        log(
            f"main path {cname}: N={h.nbins} M={M} A={A} B={B} G={mb_runs[cname]['lanes']} launches={launches} valid share {share:.6f} phases(1,2)={nph[1:3]} | "
            f"kernel {k_ms:.3f} ms = {B / k_ms * 1e3:.4g} points/s | mu_beta_sweep_thermo auto {e_ms:.3f} ms = {B / e_ms * 1e3:.4g} points/s | "
            f"plain {p_ms:.3f} ms = {B / p_ms * 1e3:.4g} points/s (peak {peak:.2f} GiB) | bound {b_ms:.4f} ms by {b_by} ({ops:.4g} f64 ops) | {smi}"
        )

    iso_runs = {}
    for cname, gname, order in ISO_CELLS:
        g, iso, grid, srcs, mk, lr, wts, mu1_v, dmu2_v = C.iso_main(gname, order)
        start_k3, start_rows = launch_count("k3"), launch_count("mb_rows")
        Z, (X, Y) = iso.make_grid(*grid)
        torch.cuda.synchronize()
        launches, rows_main[cname] = launch_count("k3") - start_k3, launch_count("mb_rows") - start_rows
        if launches < 1:
            raise AssertionError(f"{cname}: the main path launched K3 {launches} times")
        n_src = len(set(np.asarray(lr).ravel().tolist()))
        if rows_main[cname] != n_src:
            raise AssertionError(f"{cname}: the main path launched the row former {rows_main[cname]} times for {n_src} sources (one a source)")
        NY, NX = g["NY"], g["NX"]
        B = NX * NY
        if Z.shape != (NY, NX) or not np.array_equal(X[0], mu1_v) or not np.allclose(Y[:, 0], dmu2_v, rtol=0, atol=1e-12):
            raise AssertionError(f"{cname}: grid {Z.shape}, expected {(NY, NX)} cells over the planned axes")
        valid = iso.data["valid"]
        share = float(valid.mean())
        if share <= 0.5 or not np.array_equal(iso.data["fail_code"] == 0, valid):
            raise AssertionError(f"{cname}: valid share {share:.4f} (must exceed 0.5, and fail_code must be 0 exactly where valid)")
        if not all(np.isfinite(iso.data[k][valid]).all() for k in ("Z", "density", "F.E./kT")):
            raise AssertionError(f"{cname}: non-finite result on a valid cell")
        # a 64 x 64 sample of rows and columns against the plain version
        rng = np.random.default_rng(order)
        rows = np.sort(rng.choice(NY, min(NY, 64), replace=False))
        cols = np.sort(rng.choice(NX, min(NX, 64), replace=False))
        metas = [state.HistMeta(**dict(mk, max_phases=8))] * len(srcs)
        lr_s, wts_s = iso._bracket(dmu2_v[rows], 2.5)
        want = IB.iso_grid(srcs, metas, mu1_v[cols], dmu2_v[rows], lr_s, wts_s, g["beta"], order, CUTOFF, engine="torch")
        got = tuple(torch.as_tensor(iso.data[k][np.ix_(rows, cols)], device=dev) for k in ("Z", "density", "F.E./kT", "valid", "fail_code"))
        note(compare_iso(got, want, f"{cname} main path sample"), worst_iso)
        # one- and two-phase mixed surfaces among the sample's valid cells
        pro_s = IB._iso_prologue(srcs, metas[0], mu1_v[cols], dmu2_v[rows], lr_s, wts_s, g["beta"], order, CUTOFF)
        xm, _ = IB._iso_surfaces(pro_s, slice(None), order)
        n_max = segment.relextrema(xm, mk["smooth"], 8).n_max[want[3].reshape(-1)]
        nph = torch.bincount(n_max.long(), minlength=3).tolist()
        if nph[1] == 0 or nph[2] == 0:
            raise AssertionError(f"{cname}: phase counts over the sample's valid cells {nph}: both one- and two-phase surfaces must occur")

        pro = IB._iso_prologue(srcs, metas[0], mu1_v, dmu2_v, lr, wts, g["beta"], order, CUTOFF)
        kin = [pro[k] for k in ("lnpi", "op", "xrows", "krows", "a", "edge", "mu", "lr", "wts", "tg", "volume")]

        def k3():
            return cuda_iso.iso_grid(*kin, mk["smooth"], 8, order, CUTOFF)

        args = (srcs, metas, mu1_v, dmu2_v, lr, wts, g["beta"], order, CUTOFF)
        N = srcs[0].nbins
        lanes = cuda_iso.lanes_per_cell(N, B, n_sm)
        staged = C.k3_layout("staged_sources", lanes, len(srcs), NX, NY, N, order)
        k_ms = cuda_ms(k3)
        torch.cuda.reset_peak_memory_stats()
        p_ms = cuda_ms(lambda: IB.iso_grid(*args, engine="torch"))
        peak = torch.cuda.max_memory_allocated() / 2**30
        e_ms = cuda_ms(lambda: IB.iso_grid(*args))
        m_ms = cuda_ms(lambda: iso.make_grid(*grid))
        host = []  # make_grid's host bracket (per-row bisect + weights), host clock
        for _ in range(3):
            t0 = time.perf_counter()
            iso._bracket(dmu2_v, 2.5)
            host.append((time.perf_counter() - t0) * 1e3)
        br_ms = statistics.median(host)
        # work of this run's data: the plain segmentation's covered bins
        full_x, _ = IB._iso_surfaces(pro, slice(None), order)
        ext = segment.relextrema(full_x, mk["smooth"], 8)
        lefts, rights, pmask = segment.phase_bounds(ext, full_x.shape[-1], 8)
        cov = {"left": lefts, "right": rights, "mask": pmask}
        del full_x, ext
        x_ops = 2 * (2 + 4 + 2 + (7 if order == 2 else 0)) + 4  # two sides' x' (as K2), then the mix: 2 products, a sum, a divide
        key_ops = 3 * (2 * (4 + (7 if order == 2 else 0)) + 4 + 2)  # per key row: two sides' key', the mix, the multiply-add
        ops = tail_ops(cov, B, N, mk["smooth"], x_ops, key_ops)
        b_ms, b_by = bound(kin, k3(), ops)
        iso_runs[cname] = dict(NX=NX, NY=NY, B=B, N=N, order=order, lanes=lanes, staged_sources=staged, launches=launches, kernel_ms=k_ms, plain_ms=p_ms, auto_ms=e_ms,
                               make_grid_ms=m_ms, bracket_host_ms=br_ms, valid_share=share, sample_phases=nph[1:3], bound_ms=b_ms, bound_by=b_by, ops=ops,
                               covered_bins=covered_bins(cov))
        log(
            f"main path {cname}: N={N} NY={NY} NX={NX} cells={B} G={lanes} staged sources {staged} launches={launches} valid share {share:.6f} sample phases(1,2)={nph[1:3]} | "
            f"kernel {k_ms:.3f} ms = {B / k_ms * 1e3:.4g} cells/s | iso_grid auto {e_ms:.3f} ms = {B / e_ms * 1e3:.4g} cells/s | "
            f"make_grid {m_ms:.3f} ms = {B / m_ms * 1e3:.4g} cells/s (host bracket {br_ms:.3f} ms) | plain {p_ms:.3f} ms = {B / p_ms * 1e3:.4g} cells/s (peak {peak:.2f} GiB) | "
            f"bound {b_ms:.4f} ms by {b_by} ({ops:.4g} f64 ops) | {smi}"
        )

    # ---- 5. layouts: K1, K2 and K3 at G = 1 and G = 32 on each side of their rule's switch ----
    def switch(N):
        """The least point count at which K1's and K2's rule picks G = 1 for N bins."""
        return n_sm * min(N, C.launch.G1_PER_SM_CAP)

    def layout_line(kind, key, N, B, time_g, rule_of=cuda_sweep.lanes_per_point, switch_of=switch):
        row = {G: cuda_ms(lambda G=G: time_g(G)) for G in LANES}
        rule = rule_of(N, B, n_sm)
        other = 32 if rule == 1 else 1
        log(f"layout {kind} {key} B={B}: " + ", ".join(f"G={G} {t:.3f} ms" for G, t in row.items()) +
            f" | switch at B={switch_of(N)}, rule G={rule}: {row[rule] / row[other]:.3f}x the time of G={other} | {smi}")
        return dict(B=B, rule=rule, ms=row)

    layout_k1 = []
    for N in LAYOUT_NS + ("n573", "n1400"):
        n_bins = TC.CELLS[N]["N"] if isinstance(N, str) else N
        counts = {switch(n_bins) // 2, 2 * switch(n_bins), LAYOUT_POINTS}
        if isinstance(N, str) and TC.CELLS[N]["B"] < LAYOUT_POINTS:
            counts.add(TC.CELLS[N]["B"])  # the n1400 cell's own 4,096
        for B in sorted(counts):
            if isinstance(N, str):
                d, mk, mus_np = TC.cell(N, B)
            else:
                c = dict(TC.CELLS["n31"], N=N, seed=N)
                d, mk = TC.make_composite(**c), dict(nspec=2, max_order=2, used_ke=False, smooth=1, max_phases=4)
                mus_np = np.linspace(*TC.mu_window(**c), B)
            h, meta = hist(d), state.HistMeta(**mk)
            a = pipeline._reweight_coeff(h, torch.as_tensor(mus_np, device=dev))
            keys = segment.key_rows(h.mom, meta).contiguous()
            layout_k1.append(layout_line("K1", f"N={h.nbins} smooth={meta.smooth}", h.nbins, B, lambda G: cuda_sweep.sweep_thermo(
                h.lnpi, h.op, keys, h.volume, a, meta.smooth, meta.max_phases, True, _lanes=G)))
    layout_k2 = []
    A = TC.MB31["A"]
    for M in (switch(31) // 2 // A, 2 * switch(31) // A, TC.MB31["M"]):
        d, mk, mus_np, betas, dmus = TC.mb_grid(M)
        h, meta = hist(d), state.HistMeta(**mk)
        mus = torch.as_tensor(mus_np, device=dev)
        for order in MB_ORDERS:
            mu_t, a, xrows, krows, tg = pipeline._mb_inputs(h, meta, mus, betas, dmus, order, True, False)
            layout_k2.append(dict(order=order, **layout_line("K2", f"n31 o{order} M={M} A={A}", h.nbins, M * A, lambda G: cuda_mb.mb_sweep_thermo(
                h.lnpi, h.op, xrows, krows, h.volume, mu_t, a, tg, meta.nspec, meta.smooth, meta.max_phases, order, True, _lanes=G))))

    layout_k3 = []
    for gname, order in (("ISO31", 1), ("ISO31", 2), ("ISO1400", 1)):
        g = getattr(TC, gname)
        N = TC.CELLS[g["name"]]["N"]
        k3_switch = cuda_iso.g1_switch(N, n_sm)
        for B in sorted({k3_switch // 2, 2 * k3_switch, g["NX"] * g["NY"]}):
            NY = g["NY"] if B == g["NX"] * g["NY"] else (31 if N == 31 else 128)  # both divide the switch's half and double on 132 SMs
            NX = B // NY
            assert NX * NY == B, (N, B)
            mu1_v, dmu2_v = np.linspace(*TC.mu_window(**TC.CELLS[g["name"]]), NX), np.linspace(*g["dmu2"], NY)
            _, srcs, mk, lr, wts = C.iso_setup(g["name"], order, g["beta"], mu1_v, dmu2_v)
            pro = IB._iso_prologue(srcs, state.HistMeta(**dict(mk, max_phases=8)), mu1_v, dmu2_v, lr, wts, g["beta"], order, CUTOFF)
            kin = [pro[k] for k in ("lnpi", "op", "xrows", "krows", "a", "edge", "mu", "lr", "wts", "tg", "volume")]
            staged = C.k3_layout("staged_sources", 1, len(srcs), NX, NY, N, order)
            layout_k3.append(dict(order=order, NX=NX, NY=NY, staged_sources_g1=staged, **layout_line(
                "K3", f"N={N} o{order} {NY}x{NX} (G=1 stages {staged} sources)", N, B,
                lambda G: cuda_iso.iso_grid(*kin, mk["smooth"], 8, order, CUTOFF, _lanes=G), cuda_iso.lanes_per_cell, lambda N: cuda_iso.g1_switch(N, n_sm))))

    # one profiler window over three mb31_o2 "auto" calls (the mb31 grid above)
    from torch.profiler import ProfilerActivity, profile

    def mb_auto():
        return pipeline.mu_beta_sweep_thermo(h, meta, mus, betas, dmus, order=2, props=True)

    mb_auto()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            mb_auto()
        torch.cuda.synchronize()
    profile_mb = window_stats(prof, "mb_sweep_thermo_kernel")
    log_window("profile mb31_o2 auto x3", "K2", profile_mb, smi)

    # ---- 5b. coexistence: trace_coexistence on coex573 (K2's paired mode) and
    # find_phase_eq_state over a batch of guesses on n31 (K1) ----
    from fhmcanalysis_torch.core import solve as SV
    from fhmcanalysis_torch.utils import profiling as prof_mod

    d, mk, betas, guess, kw = TC.coex_grid()
    h, meta = hist(d), state.HistMeta(**mk)
    T, lnz2 = betas.shape[0], kw["lnZ_tol"] ** 2
    start_k2, start = launch_count("k2"), prof_mod.counters()
    out = SV.trace_coexistence(h, meta, betas, guess, **kw)
    torch.cuda.synchronize()
    launches, rows_main["coex573"] = launch_count("k2") - start_k2, launch_count("mb_rows") - start.get("launches.mb_rows", 0)
    if rows_main["coex573"] < 1:
        raise AssertionError("coex573: the main path never launched the row former")
    xarea_main["coex573"] = launch_count("k2_xarea") - start.get("launches.k2_xarea", 0)
    if xarea_main["coex573"] != 0:
        raise AssertionError(f"coex573: {xarea_main['coex573']} paired steps (G = 32) took K2's x' area")
    tile_main["coex573"] = launch_count("k2_tile") - start.get("launches.k2_tile", 0)
    if tile_main["coex573"] != 0:
        raise AssertionError(f"coex573: {tile_main['coex573']} paired steps (G = 32) took K2's target tile")
    steps, syncs = (prof_mod.counters().get(k, 0) - start.get(k, 0) for k in ("solver.steps", "host_syncs"))
    if launches < 3:
        raise AssertionError(f"coex573: the main path launched K2 {launches} times (the start, the steps and the properties need 3 or more)")
    P = meta.max_phases
    if out["fe"].shape != (T, P) or out["x_i"].shape != (T, P, meta.nspec) or out["mu_star"].shape != (T,):
        raise AssertionError("coex573: unexpected output shapes")
    if not bool(out["converged"].all()) or not float(out["err"].max()) <= lnz2:
        raise AssertionError(f"coex573: {int((~out['converged']).sum())} betas not converged, worst err^2 {float(out['err'].max()):.3e} > lnZ_tol^2 = {lnz2:.1e}")
    two = out["mask"].sum(-1) == 2
    fe2 = torch.where(out["mask"], out["fe"], 0.0)
    if not bool(two.all()) or not bool(torch.isfinite(fe2).all()):
        raise AssertionError("coex573: every beta must have two phases with finite free energies")
    rho = torch.where(out["mask"], out["density"], torch.nan)
    if not bool((rho.nan_to_num(0.0).amax(-1) > 2 * rho.nan_to_num(1e9).amin(-1)).all()):
        raise AssertionError("coex573: the two phases of a beta must be a vapor and a liquid (densities apart)")
    ref = SV.trace_coexistence(h, meta, betas, guess, engine="torch", **kw)
    if not torch.equal(out["converged"], ref["converged"]):
        raise AssertionError("coex573: converged differs from engine='torch'")
    d_mu = float((out["mu_star"] - ref["mu_star"]).abs().max())
    if not d_mu <= 1e-9:
        raise AssertionError(f"coex573: mu_star differs from engine='torch' by {d_mu:.3e} > 1e-9")
    dmus = (h.curr_mu[1:] - h.curr_mu[0])[None].expand(T, -1)
    betas_t = torch.as_tensor(betas, device=dev)
    arange_t = torch.arange(T, dtype=torch.int32, device=dev)
    objs = {e: SV._Objective(h, meta, betas_t, dmus, kw["order"], kw["min_width"], True, None, e, props_rows=True) for e in ("cuda", "torch")}
    at_k, at_p = (objs[e].segment(out["mu_star"], arange_t, props=True) for e in ("cuda", "torch"))
    torch.cuda.synchronize()
    for k in ("fe", "mask") + PROPS[1:]:
        if not torch.equal(at_k[k], out[k]):
            raise AssertionError(f"coex573: the trace's {k} is not the paired launch's at its mu_star")
    worst_coex = compare(at_k, at_p, True, "coex573 properties at mu_star")
    note(worst_coex, worst_mb)
    d_props = {k: float(torch.where(out["mask"][..., None] if out[k].dim() == 3 else out["mask"], (out[k] - ref[k]).abs(), 0.0).max()) for k in ("fe",) + PROPS[1:]}
    log(f"coexistence coex573: N={h.nbins} betas={T} K2 launches={launches} Nelder-Mead steps={steps} host syncs={syncs} converged {int(out['converged'].sum())}/{T} worst err^2 {float(out['err'].max()):.3e} (|dF.E.| <= {float(out['err'].max()) ** 0.5:.3e}) | "
        f"against engine='torch': converged equal, mu_star within {d_mu:.3e}, properties at the same mu_star within", json.dumps({k: float(f"{v:.3e}") for k, v in worst_coex.items()}),
        "| the two traces' properties apart by", json.dumps({k: float(f"{v:.3e}") for k, v in d_props.items()}))

    # K1: find_phase_eq_state over a batch of mu guesses
    d31c, mk31c, guesses, kw31 = TC.coex31_guesses()
    h31c, meta31c = hist(d31c), state.HistMeta(**mk31c)
    start_k1 = launch_count("k1")
    st31, mus31, err31, conv31 = SV.find_phase_eq_state(h31c, meta31c, kw31["lnZ_tol"], guesses, min_width=kw31["min_width"])
    torch.cuda.synchronize()
    launches31 = launch_count("k1") - start_k1
    if launches31 < 2:
        raise AssertionError(f"coex31: find_phase_eq_state launched K1 {launches31} times")
    _, mus31_p, err31_p, conv31_p = SV.find_phase_eq_state(h31c, meta31c, kw31["lnZ_tol"], guesses, min_width=kw31["min_width"], engine="torch")
    d_mu31 = float((mus31 - mus31_p).abs().max())
    if not (bool(conv31.all()) and torch.equal(conv31, conv31_p) and d_mu31 <= 1e-9 and float(err31.max()) <= kw31["lnZ_tol"] ** 2):
        raise AssertionError(f"coex31: converged {int(conv31.sum())}/{len(guesses)} (torch {int(conv31_p.sum())}), mu_star apart by {d_mu31:.3e}, worst err^2 {float(err31.max()):.3e}")
    if st31.lnpi.shape != (len(guesses), h31c.nbins) or st31.lnpi.device != dev:
        raise AssertionError("coex31: the coexistence states must be [B, N] on the card")
    log(f"coexistence coex31: N={h31c.nbins} guesses={len(guesses)} K1 launches={launches31} converged {int(conv31.sum())}/{len(guesses)} mu* {float(mus31.mean()):.9f} "
        f"(spread {float(mus31.max() - mus31.min()):.3e}) | against engine='torch': converged equal, mu_star within {d_mu31:.3e}")

    # times: solves/s, steps, the sync interval, the paired launch against the
    # product-diagonal alternative, the layout at the solver's point count
    coex = dict(betas=T, k2_launches=launches, d_mu_vs_torch=d_mu, worst_props_at_mu=worst_coex, props_apart=d_props)
    coex["auto_ms"] = cuda_ms(lambda: SV.trace_coexistence(h, meta, betas, guess, **kw))
    coex["torch_ms"] = cuda_ms(lambda: SV.trace_coexistence(h, meta, betas, guess, engine="torch", **kw))
    _, steps = SV._trace(h, meta, betas, guess, kw["lnZ_tol"], None, kw["order"], kw["min_width"], "auto")
    coex.update(steps_max=int(steps.max()), steps_median=float(steps.double().median()), sync_every=SV.SYNC_EVERY)
    # the sync interval: three rounds over the intervals in turn (the host's
    # clock is noisy), the median of each interval's three
    sync_runs = {k: [] for k in (1, 2, 4, 8, 16, 32)}
    sync_default = SV.SYNC_EVERY
    try:
        for r in range(3):
            for k in (list(sync_runs) if r % 2 == 0 else list(sync_runs)[::-1]):
                SV.SYNC_EVERY = k
                sync_runs[k].append(cuda_ms(lambda: SV.trace_coexistence(h, meta, betas, guess, **kw)))
    finally:
        SV.SYNC_EVERY = sync_default
    coex["sync_ms"] = {k: statistics.median(v) for k, v in sync_runs.items()}
    coex["sync_ms_runs"] = sync_runs
    log(f"coexistence coex573 times: auto {coex['auto_ms']:.3f} ms = {T / coex['auto_ms'] * 1e3:.5g} solves/s | torch {coex['torch_ms']:.3f} ms = {T / coex['torch_ms'] * 1e3:.5g} solves/s | "
        f"K2 launches per trace {launches}, Nelder-Mead steps max {coex['steps_max']} median {coex['steps_median']:g}, sync every {SV.SYNC_EVERY} | by sync interval:",
        ", ".join(f"k={k} {t:.3f} ms" for k, t in coex["sync_ms"].items()), f"| {smi}")
    coex31 = dict(guesses=len(guesses), k1_launches=launches31, d_mu_vs_torch=d_mu31)
    coex31["auto_ms"] = cuda_ms(lambda: SV.find_phase_eq_state(h31c, meta31c, kw31["lnZ_tol"], guesses, min_width=kw31["min_width"]))
    coex31["torch_ms"] = cuda_ms(lambda: SV.find_phase_eq_state(h31c, meta31c, kw31["lnZ_tol"], guesses, min_width=kw31["min_width"], engine="torch"))
    log(f"coexistence coex31 times (find_phase_eq_state, K1): auto {coex31['auto_ms']:.3f} ms = {len(guesses) / coex31['auto_ms'] * 1e3:.5g} solves/s | "
        f"torch {coex31['torch_ms']:.3f} ms = {len(guesses) / coex31['torch_ms'] * 1e3:.5g} solves/s | {smi}")

    # one solver step's K2 launch (5 candidates x T targets, props=False) at
    # its mu values, its plain version, its bound, and the product-diagonal
    # alternative: M = A = 5T, every candidate against every target's row
    obj = objs["cuda"]
    step_mu = out["mu_star"].repeat(5) + torch.linspace(-1e-3, 1e-3, 5, device=dev, dtype=torch.float64).repeat_interleave(T)
    step_tix = arange_t.repeat(5)
    step_a = pipeline._reweight_coeff(h, step_mu).contiguous()
    step_out = obj.segment(step_mu, step_tix)

    def paired_step():
        return cuda_mb.mb_sweep_thermo(h.lnpi, h.op, obj.xrows, None, h.volume, step_mu, step_a, obj.tg, meta.nspec, meta.smooth, P, kw["order"], False, tix=step_tix)

    tg_rows = obj.tg[step_tix.long()].contiguous()

    def diagonal_step():
        return cuda_mb.mb_sweep_thermo(h.lnpi, h.op, obj.xrows, None, h.volume, step_mu, step_a, tg_rows, meta.nspec, meta.smooth, P, kw["order"], False)

    pk_call_ms = cuda_ms(paired_step)
    pk_ms = device_ms(paired_step, "mb_sweep_thermo_kernel")
    pp_ms = cuda_ms(lambda: objs["torch"].segment(step_mu, step_tix))
    diag_ms = cuda_ms(diagonal_step)
    diag_dev_ms = device_ms(diagonal_step, "mb_sweep_thermo_kernel", reps=3)
    B = step_mu.shape[0]
    x_ops = 2 + 4 + (2 if meta.nspec == 2 else 0) + (7 if kw["order"] == 2 else 0)
    ops = tail_ops(step_out, B, h.nbins, meta.smooth, x_ops, 0)
    b_ms, b_by = bound([h.lnpi, h.op, obj.xrows, h.volume, step_mu, step_a, obj.tg, step_tix], step_out.values(), ops)
    coex_layout = layout_line("K2 paired", f"coex573 one step N={h.nbins} B={B} (call time)", h.nbins, B, lambda G: cuda_mb.mb_sweep_thermo(
        h.lnpi, h.op, obj.xrows, None, h.volume, step_mu, step_a, obj.tg, meta.nspec, meta.smooth, P, kw["order"], False, tix=step_tix, _lanes=G))
    coex_layout["device_ms"] = {G: device_ms(lambda G=G: cuda_mb.mb_sweep_thermo(
        h.lnpi, h.op, obj.xrows, None, h.volume, step_mu, step_a, obj.tg, meta.nspec, meta.smooth, P, kw["order"], False, tix=step_tix, _lanes=G), "mb_sweep_thermo_kernel") for G in LANES}
    log(f"layout K2 paired coex573 one step B={B} (device time, profiler): " + ", ".join(f"G={G} {t:.4f} ms" for G, t in coex_layout["device_ms"].items() if t is not None) + f" | {smi}")
    log(f"coexistence step: K2 paired at B={B} (G={cuda_mb.lanes_per_point(h.nbins, B, n_sm)}) device {pk_ms if pk_ms is None else round(pk_ms, 5)} ms, call {pk_call_ms:.4f} ms | "
        f"plain {pp_ms:.3f} ms | product diagonal, K2 at M = A = {B} ({B * B} points) device {diag_dev_ms if diag_dev_ms is None else round(diag_dev_ms, 4)} ms, call {diag_ms:.3f} ms "
        f"= {diag_ms / pk_call_ms:.1f}x the paired call | bound {b_ms:.5f} ms by {b_by} ({ops:.4g} f64 ops) | {smi}")
    mb_runs["coex573"] = dict(M=B, A=T, B=B, N=h.nbins, order=kw["order"], paired=True, props=False, lanes=cuda_mb.lanes_per_point(h.nbins, B, n_sm), launches=launches,
                              kernel_ms=pk_ms if pk_ms is not None else pk_call_ms, kernel_ms_from="profiler" if pk_ms is not None else "cuda events around the call",
                              call_ms=pk_call_ms, plain_ms=pp_ms, product_diagonal_ms=diag_ms, product_diagonal_device_ms=diag_dev_ms,
                              bound_ms=b_ms, bound_by=b_by, ops=ops, covered_bins=covered_bins(step_out))
    k1_step_a = pipeline._reweight_coeff(h31c, mus31.repeat(5)).contiguous()
    keys31 = segment.key_rows(h31c.mom, meta31c).contiguous()

    def k1_step():
        return cuda_sweep.sweep_thermo(h31c.lnpi, h31c.op, keys31, h31c.volume, k1_step_a, meta31c.smooth, meta31c.max_phases, False)

    k1_out = k1_step()
    B31 = k1_step_a.shape[0]
    ops31 = tail_ops(k1_out, B31, h31c.nbins, meta31c.smooth, 2, 0)
    b31_ms, b31_by = bound([h31c.lnpi, h31c.op, keys31, h31c.volume, k1_step_a], k1_out.values(), ops31)
    k1_dev = device_ms(k1_step, "sweep_thermo_kernel")
    runs["coex31"] = dict(B=B31, N=h31c.nbins, props=False, lanes=cuda_sweep.lanes_per_point(h31c.nbins, B31, n_sm), launches=launches31,
                          kernel_ms=k1_dev if k1_dev is not None else cuda_ms(k1_step), kernel_ms_from="profiler" if k1_dev is not None else "cuda events around the call",
                          call_ms=cuda_ms(k1_step), plain_ms=cuda_ms(lambda: pipeline.mu_sweep_body(h31c, meta31c, mus31.repeat(5), False)), bound_ms=b31_ms, bound_by=b31_by, ops=ops31)
    log(f"coexistence step (K1, coex31): B={B31} device {runs['coex31']['kernel_ms']:.5f} ms, call {runs['coex31']['call_ms']:.4f} ms | plain {runs['coex31']['plain_ms']:.3f} ms | "
        f"bound {b31_ms:.5f} ms by {b31_by} | {smi}")

    # a utils.profiling window over one "auto" trace: K2's share of device
    # time and the idle share of the window
    SV.trace_coexistence(h, meta, betas, guess, **kw)
    torch.cuda.synchronize()
    with prof_mod.trace(os.path.join(ROOT, "_profiles", "coex573")) as prof:
        SV.trace_coexistence(h, meta, betas, guess, **kw)
        torch.cuda.synchronize()
    coex["profile"] = window_stats(prof, "mb_sweep_thermo_kernel")
    log_window("profile coex573 auto x1", "K2", coex["profile"], smi)
    mb_runs["coex573"]["coexistence"] = coex
    runs["coex31"]["coexistence"] = coex31
    layout_k2.append(dict(order=kw["order"], paired=True, **coex_layout))

    # ---- 5c. the 2-D surface path (its boundary integrals: one kernel) ----
    two_dim = two_dim_phase(C)
    print(json.dumps({"two_dim": two_dim}))

    # ---- 5d. window patching into a composite K1 sweeps (no kernel of its own) ----
    wp, runs["win800"] = win_patch_phase(C, worst)
    print(json.dumps({"win_patch": wp}))

    # ---- 5e. parallel/: the mesh over the machine's cards and four shards of one ----
    par, par_cells = parallel_phase(C)
    print(json.dumps({"parallel": par}))
    for cells_k, add_k in ((runs, par_cells[cuda_sweep.NAME]), (mb_runs, par_cells[cuda_mb.NAME]), (iso_runs, par_cells[cuda_iso.NAME])):
        cells_k.update(add_k)

    # ---- 5f. capacity: the kernels' wide builds (64 phase slots, K1's nspec 3-4) ----
    cap_rec, cap_cells, cap_worst, cap_layouts = capacity_phase(C, ptxas)
    print(json.dumps({"capacity": cap_rec}))
    for cells_k, kname in ((runs, cuda_sweep.NAME), (mb_runs, cuda_mb.NAME), (iso_runs, cuda_iso.NAME)):
        cells_k.update(cap_cells[kname])

    # ---- 5g. the reference-notebook workflows of examples/ ----
    wf, wf_cells, wf_worst = workflows_phase(C)
    print(json.dumps({"workflows": wf}))
    for cells_k, kname in ((runs, cuda_sweep.NAME), (mb_runs, cuda_mb.NAME), (iso_runs, cuda_iso.NAME)):
        cells_k.update(wf_cells[kname])
    cap_worst = {k: max(v, wf_worst[k]) for k, v in cap_worst.items()}

    # ---- 6. the kernels line and the last line ----
    def entry(kname, source, cells, err, **extra):
        head = cells[next(iter(cells))]
        return {
            "name": kname,
            "route": "cuda",
            "source": source,
            "replaces": REPLACES[kname],
            "launches": sum(r["launches"] for r in cells.values()),
            "max_abs_err": err,
            "ms": head["kernel_ms"],
            "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"],
            "library_ms": None,  # no single PyTorch call computes segmentation + per-phase integration
            "cells": cells,
            "ptxas": ptxas[kname],
            **extra,
        }

    kernels = [
        entry(cuda_sweep.NAME, "fhmcanalysis_torch/csrc/sweep_thermo.cu", runs, max(*worst.values(), cap_worst[cuda_sweep.NAME]), layouts=layout_k1 + cap_layouts[cuda_sweep.NAME]),
        entry(cuda_mb.NAME, "fhmcanalysis_torch/csrc/mb_sweep_thermo.cu", mb_runs, max(*worst_mb.values(), cap_worst[cuda_mb.NAME]), layouts=layout_k2 + cap_layouts[cuda_mb.NAME],
              profile_mb31_o2=profile_mb),
        entry(cuda_iso.NAME, "fhmcanalysis_torch/csrc/iso_grid.cu", iso_runs, max(*worst_iso.values(), cap_worst[cuda_iso.NAME]), layouts=layout_k3 + cap_layouts[cuda_iso.NAME]),
        dict(row_former, launches=sum(rows_main.values()), main_path_launches=rows_main),
    ]
    b2d_cells = {f"{cname} S={S_}": {k: v for k, v in stg.items() if k.startswith(("of which", "boundary"))} for cname in ("pore96", "joint96") for S_, stg in two_dim[cname]["stages"].items()}
    head = b2d_cells["pore96 S=1024"]
    b2d_main = two_dim["b2d_main_path_launches"]
    kernels.append({
        "name": C.cuda_b2d.NAME,
        "route": "cuda",
        "source": "fhmcanalysis_torch/csrc/boundary2d.cu",
        "replaces": None,  # no TPU kernel: the JAX package's core/segment2d.py forms these integrals with jnp operations on XLA
        "launches": sum(b2d_main.values()),
        "main_path_launches": b2d_main,
        "max_abs_err": max(r["boundary max_abs_err"] for r in b2d_cells.values()),
        "ms": head["boundary kernel device"],
        "call_ms": head["of which boundary integrals"],
        "plain_ms": head["boundary plain one-hot"],
        "bound_ms": head["boundary bound"],
        "bound_by": "bytes",
        "library_ms": None,
        "cells": b2d_cells,
        "ptxas": ptxas[C.cuda_b2d.NAME],
    })
    if C.cuda_ws2d is not None:
        ws_cells = {f"{cname} S={S_}": {k: v for k, v in stg.items() if k.startswith("watershed")} for cname in ("pore96", "joint96") for S_, stg in two_dim[cname]["stages"].items()}
        head = ws_cells["pore96 S=1024"]
        ws_main = two_dim["ws2d_main_path_launches"]
        kernels.append({
            "name": C.cuda_ws2d.NAME,
            "route": "cuda",
            "source": "fhmcanalysis_torch/csrc/watershed2d.cu",
            "replaces": None,  # no TPU kernel: the JAX package's core/segment2d.py runs its watershed as jnp operations on XLA
            "launches": sum(ws_main.values()),
            "main_path_launches": ws_main,
            "max_abs_err": 0.0,  # the six outputs equal the plain function's bit for bit (watershed_stage raises otherwise)
            "ms": head["watershed kernel device"],
            "call_ms": head["watershed"],
            "plain_ms": head["watershed plain"],
            "bound_ms": head["watershed bound"],
            "bound_by": "bytes",
            "library_ms": None,
            "cells": ws_cells,
            "ptxas": ptxas[C.cuda_ws2d.NAME],
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": C.name, "count": torch.cuda.device_count()}}))


def main():
    ap = argparse.ArgumentParser(description="Drive the PyTorch port's paths on one CUDA GPU and check them.")
    ap.add_argument("--dump", metavar="PATH", help="save the kernels' main-path outputs and K3's parity cases, then stop")
    ap.add_argument("--compare", nargs=2, metavar=("A", "B"), help="set two dumps side by side")
    args = ap.parse_args()
    if args.compare:
        sys.exit(compare_dumps(*args.compare))
    if args.dump:
        dump(args.dump)
    else:
        run()


if __name__ == "__main__":
    main()
