// One cell of kernel K3 (the isopleth cell): what a group of G lanes does
// for the cell (mu_1[ix], dMu_2[iy]), b = iy * NX + ix, once its two
// sources' rows are chosen.
//
// Shared by csrc/iso_grid.cu (the kernel: staging, layout, launch) and
// tests/tail_host/ (the same code built with g++ for one lane, which the
// CPU tests hold bit for bit against the plain version,
// fhmcanalysis_torch/binary/isopleth.py iso_grid_body, and its layout
// rules, which they hold to their numbers):
//
//   for each side s in {L, R}: x'_s, key'_s as K2 forms them
//     (extrap_rows.cuh) from source lr[iy, s]'s rows, a[j, ix], mu_1[ix]
//     and the row's target scalars tg[iy, s];
//   the inverse-distance mix x_m = (x'_L w0 + x'_R w1) / (w0 + w1), and
//     key_m the same way (isopleth.py's association);
//   the tail (thermo_tail.cuh) on (x_m, key_m), with a sink that keeps
//     only the most stable phase and the final maxima;
//   the finish: safe = x_m[last maximum] - x_m[N-1] >= cutoff, guard =
//     safe and the two sources' edge flags, ok = valid and guard, the
//     fail code (0 ok, 1 edge, 2 segmentation, 3 phase overflow), and
//     x_1, density, fe of the stable phase, each 0 where not ok.
//
// x_m is read either where it is formed (XM false: each read re-forms
// two sides' x' and their mix, about 20 f64 operations with a divide) or
// from an area the cell fills once (XM true: the G lanes form bins lane,
// lane + G, ... in the same rounding sequence, then every read, the
// finish's included, is one load).  The bits are the same either way.
// kf, the key rows, is formed on read in both: the tail reads it once
// per covered bin.

#pragma once

#include "extrap_rows.cuh"
#include "thermo_tail.cuh"

namespace iso {

struct Args {
  const double* lnpi;         // [W, N]
  const double* op;           // [W, N]
  const double* xrows;        // [W, R, N]
  const double* krows;        // [W, KG, 3, N]
  const double* a;            // [W, NX]: beta_ref (mu_1 - mu_ref) per source
  const unsigned char* edge;  // [W, NX]: the source's reweighted-tail edge flag
  const double* mu;           // [NX]
  const int* lr;              // [NY, 2]: left / right source per row
  const double* wts;          // [NY, 2]: mixing weights per row
  const double* tg;           // [NY, 2, T]: target scalars per row and side
  const double* volume;       // scalar
  int W, NX, NY, N, R, KG, P, smooth, order, janus;
  double cutoff;
  int staged;                 // sources a block stages in shared memory (G = 1), 0: none
  double* z;                  // [NY, NX] x_1 of the stable phase
  double* rho;                // [NY, NX] its density
  double* fe;                 // [NY, NX] its F.E./kT
  unsigned char* ok;          // [NY, NX]
  int* code;                  // [NY, NX]
};

// One source's rows, in global memory or in a block's staged copy.
struct Rows {
  const double *lnpi, *op, *x, *k;
};

// Doubles of one source's rows: lnpi, op, xrows, krows.
__host__ __device__ __forceinline__ size_t source_doubles(const Args& g) {
  return (size_t)(2 + g.R + 3 * g.KG) * g.N;
}

__host__ __device__ __forceinline__ Rows global_rows(const Args& g, int j) {
  const size_t N = g.N;
  return Rows{g.lnpi + j * N, g.op + j * N, g.xrows + j * g.R * N, g.krows + j * g.KG * 3 * N};
}

// The kernel's shared-memory layout rules (csrc/iso_grid.cu launches by
// them and exports them; tests/tail_host/ builds them for the CPU tests).
//
// Sources a block at G = 1 may stage.
constexpr int MAX_STAGED = 32;
// Static shared bytes of the staged-source list (s_src, s_cnt): 132,
// rounded up to 16 as ptxas rounds a block's static area for the 16-byte
// aligned dynamic rows that follow it (the index slots are multiples of
// 16 already), so that the staging rule counts what the launch reserves.
constexpr size_t LIST_BYTES = (sizeof(int) * (MAX_STAGED + 1) + 15) / 16 * 16;
// Shared memory a block may opt in to on Hopper (227 KB, static and
// dynamic together): the wide build's x_m area is used where it fits.
constexpr size_t SMEM_OPTIN = 232448;

// Sources a block stages at G < 32 (0: none): its THREADS / G consecutive
// cells span at most (THREADS / G - 1) / NX + 2 rows, each naming 2 sources.
template <int G, int CAP>
int staged_sources(const Args& g) {
  const int span = (tail::THREADS / G - 1) / g.NX + 2;
  const int rows = span < g.NY ? span : g.NY;
  const int k = 2 * rows < g.W ? 2 * rows : g.W;
  const size_t bytes = k * source_doubles(g) * sizeof(double) + LIST_BYTES;
  return k <= MAX_STAGED && tail::stages_rows<G, CAP>(bytes) ? k : 0;
}

// The x_m area of a block: THREADS/G cells of N doubles.
template <int G>
size_t xm_area(const Args& g) {
  return (size_t)(tail::THREADS / G) * g.N * sizeof(double);
}

// Bytes of the x_m area a block of the build reserves (0: x_m is formed
// on read): the wide build's, where the block's static slots and list,
// its staged rows and the area fit SMEM_OPTIN.
template <int G, int CAP>
size_t xm_bytes(const Args& g, int staged) {
  if (CAP <= tail::SMALL) return 0;
  const size_t fixed = tail::slot_bytes(G, CAP) + (G < 32 ? LIST_BYTES : 0) + staged * source_doubles(g) * sizeof(double);
  return fixed + xm_area<G>(g) <= SMEM_OPTIN ? xm_area<G>(g) : 0;
}

// A grid's sizes, as the rules above read them.
inline Args grid_args(int W, int NX, int NY, int N, int R, int KG) {
  Args g{};
  g.W = W, g.NX = NX, g.NY = NY, g.N = N, g.R = R, g.KG = KG;
  return g;
}

// staged_sources for G and the build of `cap` phase slots named at run
// time: none at G != 1.
inline int staged_sources(int G, int cap, const Args& g) {
  if (G != 1) return 0;
  return cap == tail::WIDE ? staged_sources<1, tail::WIDE>(g) : staged_sources<1, tail::SMALL>(g);
}

// xm_bytes beside the rows a block stages, for G and `cap` named at run
// time: none outside the wide build and at a G the kernel does not build.
inline int xm_bytes(int G, int cap, const Args& g) {
  if (cap != tail::WIDE) return 0;
  if (G == 1) return (int)xm_bytes<1, tail::WIDE>(g, staged_sources<1, tail::WIDE>(g));
  return G == 32 ? (int)xm_bytes<32, tail::WIDE>(g, 0) : 0;
}

// Static shared bytes of a block: its index slots and, at G < 32, the
// staged-source list.
inline int static_bytes(int G, int cap) { return tail::slot_bytes(G, cap) + (G < 32 ? (int)LIST_BYTES : 0); }

// Keeps what the finish needs: the stable phase and the last maximum.
struct IsoSink {
  int P;
  const double* volume;
  double best, z, rho, fe;
  int n_max, last_max;
  bool valid;

  __device__ __forceinline__ void phase(int p, int, int, bool mask, double phase_fe, const double* acc) {
    // argmin of where(mask, fe, inf): the first slot of the least value
    const double cand = mask ? phase_fe : INFINITY;
    if (p == 0 || cand < best) {
      double ni[2], nt, u;
      tail::phase_props(acc, 2, ni, nt, u);
      best = cand;
      z = ni[0] / (nt != 0.0 ? nt : 1.0);
      rho = nt / *volume;
      fe = phase_fe;
    }
  }

  __device__ __forceinline__ void finish(int nm, bool v, int lm) {
    n_max = nm;
    valid = v;
    last_max = lm;
  }

  // the wide build's row: its masked phases, from the group's first lane
  // (a slot past the count is unmasked, so never the stable phase)
  static constexpr bool ROW_ON_EVERY_LANE = false;
  template <int G, int CAP, int KACC>
  __device__ __forceinline__ void row(const tail::Group<G>& grp, const tail::WideRow<CAP, KACC>& w) {
    if (grp.lane == 0)
      for (int p = 0; p < w.nmask; ++p) phase(p, w.lo[p], w.hi[p], true, w.phase_fe(p), w.acc[p]);
  }
};

// Cell b = iy * NX + ix between sources jl and jr, whose rows are rl and
// rr, on the G lanes of grp; mx, mn are its index slots, `pitch` apart.
// XM: xm holds the cell's N bins of x_m, `xpitch` apart, and the group
// fills them here first.  NC: the rows are read through the read-only
// cache.  The group's first lane writes the outputs.
template <int G, int CAP, bool NC, bool XM>
__device__ __forceinline__ void cell(const Args& g, long long b, int iy, int ix, int jl, int jr, const Rows& rl, const Rows& rr,
                                     const tail::Group<G>& grp, int* mx, int* mn, int pitch, double* xm, int xpitch) {
  // the cell's scalars, once per lane
  const int S = 2, N = g.N, T = tail::n_targets(S, g.order);
  const double w0 = g.wts[2 * iy], w1 = g.wts[2 * iy + 1];
  const double wsum = __dadd_rn(w0, w1);
  const double mu = g.mu[ix];
  const size_t KN = (size_t)(S + 1) * N;
  const bool o2 = g.order >= 2;  // nspec 2; the order-2 key-row terms apply with the x' ones
  const tail::Targets tl = tail::targets(g.tg + (size_t)(2 * iy) * T, S, g.order);
  const tail::Targets tr = tail::targets(g.tg + (size_t)(2 * iy + 1) * T, S, g.order);
  const double al = g.a[(size_t)jl * g.NX + ix], ar = g.a[(size_t)jr * g.NX + ix];
  const auto mix = [&](double l, double r) {
    return __ddiv_rn(__dadd_rn(__dmul_rn(l, w0), __dmul_rn(r, w1)), wsum);
  };
  const auto form = [&](int i) {
    return mix(tail::extrap_x<NC>(rl.lnpi, rl.op, rl.x, N, true, o2, al, mu, tl, i),
               tail::extrap_x<NC>(rr.lnpi, rr.op, rr.x, N, true, o2, ar, mu, tr, i));
  };
  const auto kf = [&](int k, int i) {
    return mix(tail::extrap_key<NC>(rl.k, N, KN, true, o2, tl, k, i), tail::extrap_key<NC>(rr.k, N, KN, true, o2, tr, k, i));
  };
  if constexpr (XM) {
    for (int i = grp.lane; i < N; i += G) xm[i * xpitch] = form(i);
    tail::grp_sync(grp);
  }
  const auto xf = [&](int i) {
    if constexpr (XM) return xm[i * xpitch];
    else return form(i);
  };

  IsoSink sink{g.P, g.volume, INFINITY, 0.0, 0.0, 0.0, 0, 0, false};
  tail::thermo_point<CAP, 4>(xf, kf, grp, N, S, g.P, g.smooth, 1, g.janus, sink, mx, mn, pitch);

  if (grp.lane == 0) {
    const int lm = min(max(sink.last_max, 0), N - 1);
    const bool safe = __dsub_rn(xf(lm), xf(N - 1)) >= g.cutoff;
    const bool guard = safe && g.edge[(size_t)jl * g.NX + ix] && g.edge[(size_t)jr * g.NX + ix];
    const bool ok = sink.valid && guard;
    g.code[b] = sink.valid ? (guard ? 0 : 1) : (sink.n_max > g.P ? 3 : 2);
    g.ok[b] = ok ? 1 : 0;
    g.z[b] = ok ? sink.z : 0.0;
    g.rho[b] = ok ? sink.rho : 0.0;
    g.fe[b] = ok ? sink.fe : 0.0;
  }
}

}  // namespace iso
