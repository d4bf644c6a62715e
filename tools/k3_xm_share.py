#!/usr/bin/env python3
"""What forming x_m costs kernel K3's wide build on the card.

    python3 tools/k3_xm_share.py

Builds a timing variant of fhmcanalysis_torch/csrc/iso_grid.cu in a
temporary directory, in which a cell's formation of its mixed surface x_m
(two sides' x' and the mix: the `form` lambda of csrc/iso_cell.cuh) is
one read of a table of every cell's x_m that the plain version computed
(binary.isopleth._iso_surfaces).  The table holds the doubles the kernel
forms, so the variant writes the kernel's outputs bit for bit and runs
its control flow: only the formation's arithmetic and row reads go.

On overflow31 (301 x 834 cells, N = 31) and overflow1400 (128 x 128
cells, N = 1400) at 16 and 64 phase slots it times the kernel and the
variant in turns (kernel, variant, variant, kernel; CUDA events, warm,
the median of 3 reps of 10 launches each) at G = 1 and G = 32, with x_m
formed on read (_xm=False: the layout before the x_m area, every read
re-forms it) and with the library's layout (the x_m area where it fits).
The formation's share of a layout's time is (kernel - variant) / kernel.
With --keys the variant reads the mixed key rows key_m (kf, formed on
read in every build: the tail reads them once per covered bin) from a
table too, so the difference between the two runs is what forming key_m
costs.

    python3 tools/k3_xm_share.py --bounds B1 B32

instead builds a variant whose wide build asks __launch_bounds__ for B1
blocks an SM at G = 1 and B32 at G = 32 (the kernel's G1_MIN_BLOCKS and
WIDE_G32_MIN_BLOCKS), prints its ptxas registers, stack and spill, and
times it against the kernel in the same turns at the library's layout.

Prints one line per case with the card's name and power limit, then a
JSON line.  Needs one CUDA card and nvcc, as chip_smoke.py does.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT]

import chip_smoke as CSM  # noqa: E402

FORM = """  const auto form = [&](int i) {
    return mix(tail::extrap_x<NC>(rl.lnpi, rl.op, rl.x, N, true, o2, al, mu, tl, i),
               tail::extrap_x<NC>(rr.lnpi, rr.op, rr.x, N, true, o2, ar, mu, tr, i));
  };"""
TABLE = """  const auto form = [&](int i) { return __ldg(xm_table + (size_t)b * N + i); };"""
KFORM = """  const auto kf = [&](int k, int i) {
    return mix(tail::extrap_key<NC>(rl.k, N, KN, true, o2, tl, k, i), tail::extrap_key<NC>(rr.k, N, KN, true, o2, tr, k, i));
  };"""
KTABLE = """  const auto kf = [&](int k, int i) { return __ldg(xm_table + (size_t)g.NX * g.NY * N + ((size_t)b * 3 + k) * N + i); };"""
CELL = "template <int G, int CAP, bool NC, bool XM>\n__device__ __forceinline__ void cell("
SETTER = """
extern "C" int iso_grid_set_xm_table(const double* p) { return (int)cudaMemcpyToSymbol(iso::xm_table, &p, sizeof(p)); }
"""
BOUNDS = "  return G == 1 ? G1_MIN_BLOCKS : (CAP > tail::SMALL ? WIDE_G32_MIN_BLOCKS : 1);"
REPS, LAUNCHES = 3, 10


def patch(path, old, new):
    text = open(path).read()
    if text.count(old) != 1:
        raise SystemExit(f"k3_xm_share: {os.path.basename(path)} no longer has the code this tool replaces")
    open(path, "w").write(text.replace(old, new))


def build_variant(tmp, bounds=None, keys=False):
    """The variant library: csrc/ copied to tmp, the formation of x_m (and
    with keys of key_m) replaced by the table read (or, with bounds, the
    wide build's launch bounds replaced), built with the package's nvcc
    flags."""
    from fhmcanalysis_torch import _build

    src = os.path.join(tmp, "csrc")
    shutil.copytree(_build.CSRC, src)
    if bounds:
        patch(os.path.join(src, "iso_grid.cu"), BOUNDS, f"  return CAP > tail::SMALL ? (G == 1 ? {bounds[0]} : {bounds[1]}) : (G == 1 ? G1_MIN_BLOCKS : 1);")
    else:
        patch(os.path.join(src, "iso_cell.cuh"), FORM, TABLE)
        if keys:
            patch(os.path.join(src, "iso_cell.cuh"), KFORM, KTABLE)
        patch(os.path.join(src, "iso_cell.cuh"), CELL, "__device__ const double* xm_table;  // [cells, N]\n\n" + CELL)
        with open(os.path.join(src, "iso_grid.cu"), "a") as f:
            f.write(SETTER)
    so = os.path.join(tmp, "libiso_grid_table.so")
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", src, "-o", so, os.path.join(src, "iso_grid.cu")], capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"k3_xm_share: nvcc failed:\n{proc.stdout}\n{proc.stderr}")
    return ctypes.CDLL(so), [r for r in CSM.ptxas_report(proc.stdout + proc.stderr) if r[2] == 64]


def main():
    ap = argparse.ArgumentParser(description="What forming x_m costs K3's wide build; or its launch bounds.")
    ap.add_argument("--bounds", nargs=2, type=int, metavar=("B1", "B32"), help="time a variant of these wide-build launch bounds instead")
    ap.add_argument("--keys", action="store_true", help="the variant reads key_m from the table too")
    args = ap.parse_args()
    bounds, keys = args.bounds, args.keys
    C = CSM.Ctx()
    torch, cuda_iso, IB, state = C.torch, C.cuda_iso, C.IB, C.state
    kernel = cuda_iso._lib()
    what = f"bounds {bounds[0]}/{bounds[1]}" if bounds else "x_m and key_m from the table" if keys else "x_m from the table"
    with tempfile.TemporaryDirectory() as tmp:
        variant, ptxas = build_variant(tmp, bounds, keys)
        for fn in ("iso_grid_launch", "iso_grid_error_string"):
            getattr(variant, fn).argtypes = getattr(kernel, fn).argtypes
            getattr(variant, fn).restype = getattr(kernel, fn).restype
        if not bounds:
            variant.iso_grid_set_xm_table.argtypes = [ctypes.c_void_p]
        for r in ptxas:
            CSM.log(f"variant ptxas {r[0]} G={r[1]} cap={r[2]}: {r[4]} registers, {r[5]} bytes stack, {r[6]} bytes spill stores")

        def on(lib, fn):
            cuda_iso._lib = lambda: lib
            try:
                return fn()
            finally:
                cuda_iso._lib = lambda: kernel

        def ms(lib, fn):
            def launches():
                for _ in range(LAUNCHES):
                    fn()

            return on(lib, lambda: CSM.cuda_ms(launches, REPS)) / LAUNCHES

        rows = []
        for name in ("overflow31", "overflow1400"):
            srcs, mk, mu1_v, dmu2_v, lr, wts, beta = C.overflow_sources(name)
            NX, NY, N = len(mu1_v), len(dmu2_v), srcs[0].nbins
            for P in (16, 64):
                pro = IB._iso_prologue(srcs, state.HistMeta(**dict(mk, max_phases=P)), mu1_v, dmu2_v, lr, wts, beta, 1, CSM.CUTOFF)
                kin = [pro[k] for k in ("lnpi", "op", "xrows", "krows", "a", "edge", "mu", "lr", "wts", "tg", "volume")]
                if not bounds:
                    xm_t, km_t = IB._iso_surfaces(pro, slice(None), 1)
                    table = torch.cat([xm_t.reshape(-1), km_t.reshape(-1)]) if keys else xm_t.contiguous()
                    if variant.iso_grid_set_xm_table(table.data_ptr()) != 0:
                        raise SystemExit("k3_xm_share: could not set the table")
                for G in (1, 32):
                    for xm in (None,) if bounds else (False, None):
                        area = cuda_iso.xm_bytes(G, len(srcs), NX, NY, N, 1, P) if xm is None else 0
                        if xm is None and not area and not bounds:
                            continue  # the library's layout is x_m on read here: the row above
                        fn = lambda G=G, xm=xm: cuda_iso.iso_grid(*kin, mk["smooth"], P, 1, CSM.CUTOFF, _lanes=G, _xm=xm)  # noqa: E731
                        want, got = on(kernel, fn), on(variant, fn)
                        torch.cuda.synchronize()
                        same = all(torch.equal(a, b) for a, b in zip(want, got))
                        if not same:
                            raise SystemExit(f"k3_xm_share: {name} P={P} G={G} xm={xm}: the variant's outputs differ from the kernel's")
                        t = [ms(kernel, fn), ms(variant, fn), ms(variant, fn), ms(kernel, fn)]
                        k_ms, v_ms = statistics.mean((t[0], t[3])), statistics.mean((t[1], t[2]))
                        row = dict(cell=name, N=N, B=NX * NY, max_phases=P, lanes=G, layout="x_m area" if area else "x_m on read", xm_bytes=area,
                                   kernel_ms=[t[0], t[3]], variant_ms=[t[1], t[2]], share=(k_ms - v_ms) / k_ms, bit_identical=same)
                        rows.append(row)
                        CSM.log(f"k3 {what} {name} P={P} G={G} {row['layout']} ({area} B): kernel {t[0]:.4f} / {t[3]:.4f} ms, {what} "
                                f"{t[1]:.4f} / {t[2]:.4f} ms, (kernel - variant) / kernel {row['share'] * 100:.1f}% | {C.smi}")
    print(json.dumps({"k3_xm_share": rows, "variant": what, "variant_ptxas": ptxas, "device": C.name, "smi": C.smi}))


if __name__ == "__main__":
    main()
