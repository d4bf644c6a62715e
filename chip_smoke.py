#!/usr/bin/env python3
"""Drive the PyTorch port's paths on one CUDA GPU and check them.

    python3 chip_smoke.py
    python3 chip_smoke.py --dump PATH      # save the main paths' outputs
    python3 chip_smoke.py --compare A B    # set two such dumps side by side

Phases (each raises on failure, so any failure exits non-zero):
  1. device: require a CUDA device (no CPU fallback); print the card's
     name and power limit as nvidia-smi reports them;
  2. build: compile every kernel from csrc/ with nvcc, one nvcc per
     source, all started together; print ptxas registers/stack/spills per
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
     every G; K3 (the isopleth cell) over its coverage (orders 1-2,
     collect None/"janus", 2-3 sources, clamped rows, used_ke, max_phases
     4/8, N 31 and 1400, the fail-code surfaces, a narrow grid over five
     sources, a partial last block) at <=4,096 cells per case, at the G
     its rule picks and forced to every G: valid and fail_code equal,
     floats within 1e-10 abs on ok cells;
  4. main paths, each with its launch counter reset just before and read
     just after: pipeline.mu_sweep_thermo(engine="auto") on the N=573
     (B=524,288) and N=31 (B=2,097,152) cells;
     pipeline.mu_beta_sweep_thermo(engine="auto") on mb31 at orders 1 and
     2 (65,536 mu x 64 targets = 4,194,304 points): phases cross from one
     to two, a sample agrees with the plain version; and
     binary.isopleth.isopleth(...).make_grid(engine="auto") on iso31 at
     orders 1 and 2 (301 dMu_2 x 834 mu_1 = 251,034 cells) and on iso1400
     (128 x 128 cells at N=1400): most cells valid, one- and two-phase
     surfaces, a sample agrees with the plain version.  Kernel, plain
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
  6. a {"kernels": [...]} line with each kernel's launches, worst error,
     times and bound, then the last line: {"ok": true, "device": {...}}.

--dump PATH runs only phases 1-2 and the main paths of K1, K2 and K3 (a
strided sample of the sweeps' points, every isopleth cell) and K3's parity
cases, through entry points every tree of the port has had since K3, and
saves the kernels' outputs, K3's also forced to G = 32 (" G=32" keys; a
tree whose K3 has no other layout runs it there by default); run it from
a copy of this file, with tests/torch_composites.py, placed in another
tree to dump that tree's kernels.  --compare A B prints,
per output, whether segmentation is equal, whether every field is
bit-identical, and the worst float difference.
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

TOL = 1e-10  # the JAX package's kernel bar (tests/test_pallas_sweep.py)
SEG = ("valid", "mask", "n_phases", "left", "right")
PROPS = ("n_i", "x_i", "ntot", "u", "density")
MAIN_CELLS = ("n573", "n31")
MB_ORDERS = (1, 2)  # main-path cells mb31_o1, mb31_o2
ISO_CELLS = (("iso31_o1", "ISO31", 1), ("iso31_o2", "ISO31", 2), ("iso1400_o1", "ISO1400", 1))
LAYOUT_NS = (31, 63, 127, 255, 573, 1400)  # K1's layout timing, smooth 1, plus the n573 and n1400 cells
LAYOUT_POINTS = 262_144
DUMP_POINTS = 131_072  # per sweep cell in --dump
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


def bound(inputs, outputs, ops):
    """(bound_ms, bound_by) for a kernel call: bytes of every input and
    output tensor once over the memory rate, against ops over the f64 peak."""
    nbytes = sum(t.numel() * t.element_size() for t in list(inputs) + list(outputs) if t is not None)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP64_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def covered_bins(out):
    """Bins summed by the tail over all points and phases of this run: the
    per-phase max, exp and sums run over [left, right) of each real phase."""
    return int(((out["right"] - out["left"]).clamp(min=0) * out["mask"]).sum())


def tail_ops(out, B, N, smooth, x_ops, key_ops):
    """f64 operations the tail needs for this run's data: x once per bin
    (x_ops) and the 4*smooth stencil compares per bin and point; per
    covered bin the phase max, the shift, one exp, the weight sum and the
    key rows (key_ops: forming each key row and its multiply-add).  The
    segmentation's integer logic (O(P^2) per point) is not counted."""
    return B * N * (x_ops + 4 * smooth) + covered_bins(out) * (3 + EXP_OPS + key_ops)


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
    """[(kernel, G or None, registers, stack bytes, spill store bytes)] from
    nvcc --ptxas-options=-v output; G from the kernel's template argument."""
    rows, fn, stack, spill = [], None, 0, 0
    for line in text.splitlines():
        if m := re.search(r"Function properties for (\S+)", line):
            fn = m.group(1)
        elif m := re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores", line):
            stack, spill = int(m.group(1)), int(m.group(2))
        elif (m := re.search(r"Used (\d+) registers", line)) and fn:
            kname = re.search(r"\d+([a-z_]+_kernel)", fn)
            lanes = re.search(r"ILi(\d+)E", fn)
            rows.append((kname.group(1) if kname else fn, int(lanes.group(1)) if lanes else None, int(m.group(1)), stack, spill))
            fn = None
    return rows


class Ctx:
    """What every phase uses: torch, numpy, the composites, the port's
    modules, the card."""

    def __init__(self):
        import torch

        if not torch.cuda.is_available():
            raise SystemExit("chip_smoke: no CUDA device; this check runs only on a GPU")
        root = os.path.dirname(os.path.abspath(__file__))
        sys.path[:0] = [root, os.path.join(root, "tests")]
        import numpy as np

        import torch_composites as TC
        from fhmcanalysis_torch import _build
        from fhmcanalysis_torch.binary import isopleth as iso_cls
        from fhmcanalysis_torch.core import cuda_iso, cuda_mb, cuda_sweep, pipeline, segment, state

        self.torch, self.np, self.TC, self._build = torch, np, TC, _build
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
        libs = (self.cuda_sweep, self.cuda_mb, self.cuda_iso)
        t0 = time.perf_counter()
        with ThreadPoolExecutor(len(libs)) as pool:
            list(pool.map(lambda mod: mod._lib(), libs))
        log(f"build: {', '.join(mod.NAME for mod in libs)} ready in {time.perf_counter() - t0:.1f} s")
        report = {}
        for mod in libs:
            info = self._build.BUILD_INFO.get(mod.NAME, {})
            rows = ptxas_report(info.get("log", ""))
            report[mod.NAME] = [dict(kernel=k, lanes=g, registers=r, stack=st, spill_stores=sp) for k, g, r, st, sp in rows]
            log(f"  {mod.NAME}: nvcc {info.get('seconds', 0.0):.1f} s")
            for k, g, r, st, sp in rows:
                log(f"  ptxas: {k}" + (f" G={g}" if g else "") + f": {r} registers, {st} bytes stack, {sp} bytes spill stores")
        return report

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


def dump(path):
    """--dump: the kernels' outputs on the main paths (a strided sample of
    the sweeps' points, every isopleth cell) and on K3's parity cases."""
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
    for cname, gname, order in ISO_CELLS:
        g, iso, grid, srcs, mk, lr, wts, mu1_v, dmu2_v = C.iso_main(gname, order)
        iso.make_grid(*grid)
        out[f"K3 {cname}"] = {k: torch.as_tensor(np.asarray(iso.data[k])) for k in ("Z", "density", "F.E./kT", "valid", "fail_code")}
        metas = [C.state.HistMeta(**dict(mk, max_phases=8))] * len(srcs)
        out[f"K3 {cname} G=32"] = k3_g32((srcs, metas, mu1_v, dmu2_v, lr, wts, g["beta"], order, CUTOFF))
    for i, kw in enumerate(k3_cases(np, TC)):
        kw.pop("min_ok", None)
        args = C.iso_args(**kw)
        got = C.IB.iso_grid(*args, engine="cuda")
        out[f"K3 case {i}"] = dict(zip(iso_names, (t.cpu() for t in got)))
        out[f"K3 case {i} G=32"] = k3_g32(args)
    torch.cuda.synchronize()
    torch.save(out, path)
    log(f"dump: {len(out)} outputs to {path}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": C.name, "count": torch.cuda.device_count()}}))


def compare_dumps(path_a, path_b):
    """--compare: per output of two dumps, segmentation equal, every field
    bit-identical, and the worst float difference; exits 1 where any
    integer or boolean field differs."""
    import torch

    a, b = torch.load(path_a), torch.load(path_b)
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
    print(json.dumps({"ok": seg_ok, "compared": len(a)}))
    return 0 if seg_ok else 1


def run():
    C = Ctx()
    torch, np, TC = C.torch, C.np, C.TC
    cuda_sweep, cuda_mb, cuda_iso, pipeline, segment, state, IB = C.cuda_sweep, C.cuda_mb, C.cuda_iso, C.pipeline, C.segment, C.state, C.IB
    dev, smi, hist = C.dev, C.smi, C.hist
    LANES = cuda_sweep.LANES
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
        ops = tail_ops(out, B, h.nbins, meta.smooth, 2, 2 * (meta.nspec + 1))
        b_ms, b_by = bound([h.lnpi, h.op, keys, h.volume, a], out.values(), ops)
        runs[cname] = dict(B=B, N=h.nbins, lanes=cuda_sweep.lanes_per_point(h.nbins, B, n_sm), launches=launches, kernel_ms=k_ms, plain_ms=p_ms, auto_ms=e_ms, phases=nph[1:3],
                           bound_ms=b_ms, bound_by=b_by, ops=ops, covered_bins=covered_bins(out))
        log(
            f"main path {cname}: N={h.nbins} B={B} G={runs[cname]['lanes']} launches={launches} phases(1,2)={nph[1:3]} | "
            f"kernel {k_ms:.3f} ms = {B / k_ms * 1e3:.4g} points/s | mu_sweep_thermo auto {e_ms:.3f} ms = {B / e_ms * 1e3:.4g} points/s | "
            f"plain {p_ms:.3f} ms = {B / p_ms * 1e3:.4g} points/s (peak {peak:.2f} GiB) | bound {b_ms:.4f} ms by {b_by} ({ops:.4g} f64 ops) | {smi}"
        )

    mb_runs = {}
    d, mk, mus_np, betas, dmus = TC.mb_grid()
    h, meta = hist(d), state.HistMeta(**mk)
    mus = torch.as_tensor(mus_np, device=dev)
    M, A = mus.shape[0], betas.shape[0]
    for order in MB_ORDERS:
        cname = f"mb31_o{order}"
        cuda_mb.mb_sweep_thermo.launches = 0
        out = pipeline.mu_beta_sweep_thermo(h, meta, mus, betas, dmus, order=order, props=True)
        torch.cuda.synchronize()
        launches = cuda_mb.mb_sweep_thermo.launches
        if launches < 1:
            raise AssertionError(f"{cname}: the main path launched K2 {launches} times")
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
        mb_runs[cname] = dict(M=M, A=A, B=B, N=h.nbins, order=order, lanes=cuda_mb.lanes_per_point(h.nbins, M * A, n_sm), launches=launches, kernel_ms=k_ms, plain_ms=p_ms, auto_ms=e_ms,
                              phases=nph[1:3], valid_share=share, bound_ms=b_ms, bound_by=b_by, ops=ops, covered_bins=covered_bins(mb_flat(out)))
        log(
            f"main path {cname}: N={h.nbins} M={M} A={A} B={B} G={mb_runs[cname]['lanes']} launches={launches} valid share {share:.6f} phases(1,2)={nph[1:3]} | "
            f"kernel {k_ms:.3f} ms = {B / k_ms * 1e3:.4g} points/s | mu_beta_sweep_thermo auto {e_ms:.3f} ms = {B / e_ms * 1e3:.4g} points/s | "
            f"plain {p_ms:.3f} ms = {B / p_ms * 1e3:.4g} points/s (peak {peak:.2f} GiB) | bound {b_ms:.4f} ms by {b_by} ({ops:.4g} f64 ops) | {smi}"
        )

    iso_runs = {}
    for cname, gname, order in ISO_CELLS:
        g, iso, grid, srcs, mk, lr, wts, mu1_v, dmu2_v = C.iso_main(gname, order)
        cuda_iso.iso_grid.launches = 0
        Z, (X, Y) = iso.make_grid(*grid)
        torch.cuda.synchronize()
        launches = cuda_iso.iso_grid.launches
        if launches < 1:
            raise AssertionError(f"{cname}: the main path launched K3 {launches} times")
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
        staged = cuda_iso.staged_sources(lanes, len(srcs), NX, NY, N, order)
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
        return n_sm * min(N, cuda_sweep.G1_PER_SM_CAP)

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
            staged = cuda_iso.staged_sources(1, len(srcs), NX, NY, N, order)
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
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events() if e.device_type.name == "CUDA" and e.time_range.end > e.time_range.start)
    profile_mb = None
    if spans:
        busy, end = 0.0, spans[0][0]
        for t0, t1, _ in spans:  # the union of device intervals
            busy += max(0.0, t1 - max(t0, end))
            end = max(end, t1)
        window = spans[-1][1] - spans[0][0]
        k2_us = sum(t1 - t0 for t0, t1, n in spans if "mb_sweep_thermo_kernel" in n)
        profile_mb = dict(window_ms=window / 1e3, device_busy_ms=busy / 1e3, k2_ms=k2_us / 1e3, k2_share_of_device=k2_us / busy, idle_share=1 - busy / window, device_ops=len(spans))
        log(f"profile mb31_o2 auto x3: window {window / 1e3:.3f} ms (first to last device op), device busy {busy / 1e3:.3f} ms, "
            f"K2 {k2_us / 1e3:.3f} ms = {100 * k2_us / busy:.1f}% of device time, idle {100 * (1 - busy / window):.1f}% of the window, {len(spans)} device ops | {smi}")
    else:
        log("profile mb31_o2 auto x3: the profiler recorded no device time (not measured)")

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
        entry(cuda_sweep.NAME, "fhmcanalysis_torch/csrc/sweep_thermo.cu", runs, max(worst.values()), layouts=layout_k1),
        entry(cuda_mb.NAME, "fhmcanalysis_torch/csrc/mb_sweep_thermo.cu", mb_runs, max(worst_mb.values()), layouts=layout_k2, profile_mb31_o2=profile_mb),
        entry(cuda_iso.NAME, "fhmcanalysis_torch/csrc/iso_grid.cu", iso_runs, max(worst_iso.values()), layouts=layout_k3),
    ]
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
