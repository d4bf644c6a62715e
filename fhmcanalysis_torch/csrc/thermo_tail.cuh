// The segmentation + per-phase integration tail shared by the sweep kernels.
//
// The counterpart of the TPU kernels' shared stage
// fhmcanalysis_tpu/core/pallas_sweep.py thermo_lanes: given one state
// point's reweighted (and possibly extrapolated) surface x(i) and its key
// moment rows key_k(i), one group of G lanes computes
//
//   smooth-window extrema flags, compacted to the first P maxima / P+1 minima
//   endpoint rules, over-smoothing repair, alternation checks, janus collect
//   phase bounds, per-phase max m_p, per-phase sums of exp(x - m_p) * key
//   with bin N-1 added per phase, then fe, <N_i>, <U>, N_tot, x_i, density
//
// with the float64 semantics of the plain version, fhmcanalysis_torch/core/
// segment.py.  The caller says how x and the key rows are read: `xf(i)`
// returns x at bin i and `kf(k, i)` key row k (0..S) at bin i, both
// recomputed wherever they are needed rather than staged per point, so the
// tail has no shared-memory limit in N.  Segmentation compares x values
// exactly, so a caller must form x bit-identically to its plain version
// (__dmul_rn / __dadd_rn, and the library built with -fmad=false).
//
// The caller also says where the results go: a sink whose phase(p, left,
// right, mask, fe, acc) is called on the group's first lane once per
// phase slot p = 0..P-1, with acc = [sum w, sum w key_0 .. key_S] the
// phase's sums (props only), and whose finish(n_max, valid, last_max) is
// called there at the end with the final count and last index of the
// maxima (after the janus collect).  The wide build hands the sink the
// whole row at once instead (row(grp, WideRow), on every lane of the
// group).  K1 and K2 pass OutSink, which writes the [B, P] output rows;
// K3 keeps only the most stable phase.  phase_props is the arithmetic
// both use.
//
// The tail is also a template on two capacities, so that every kernel has
// a build for each and the wrappers pick the smallest that holds the run:
// CAP, the phase slots a point holds (SMALL = 8: every kernel's first
// build, where all of its speed is; WIDE = 64, the JAX package's cap of
// the padded device representation, histogram/ntot.py), which sizes the
// per-point index arrays, and KACC, the per-phase sums (1 + nspec + 1: 4
// for nspec <= 2, 6 for K1's nspec 3-4), which sizes acc and the sink's
// <N_i>.  Every loop runs to the run's P and K, not to the capacity, so a
// run's arithmetic, and its bits, do not depend on the build that holds
// it: K2 at identity targets equals K1 at every capacity.
//
// The layout is a template on G, the lanes per point: a power of two that
// divides 32, so a warp holds 32/G points and a block of THREADS threads
// THREADS/G.  A point's G lanes split every bin-parallel stage (stencil,
// ballot compaction, arg-min gap scans, max and sum reductions) and run
// the short data-dependent repair logic, over at most 2P+1 indices, each
// on its own copy, so no lane waits for a broadcast.  Every collective
// names the group's lanes only (Group::mask, shuffle width G), so groups of
// one warp run apart: trip counts differ between points, and a group past
// the end of the grid may leave early.  K1 and K2 build G = 1 and G = 32,
// K3 only G = 32.  G = 32 is one point per warp: it runs the scalar logic
// on 32 lanes for one point, and is the layout for sweeps too small to
// fill the card otherwise; G = 1 (the TPU kernel's layout: one point per
// lane, the bins walked serially) runs it once per point with 32 points
// sharing each warp instruction.  The sums over a phase are a G-lane tree over
// lane-strided partial sums, so floats depend on G in the last bits;
// segmentation compares x values only and does not.
//
// The two builds keep a point's state differently.  The small build
// (thermo_point_small) copies the compacted index lists into the lane's
// own arrays at every stage and runs each loop to P: at CAP = 8 those
// arrays are a few registers' worth, and unrolling them into registers
// made K2 at G = 1 40% slower (PERF.md).  The wide build
// (thermo_point_wide, CAP = 64) keeps only the two compacted lists,
// CAP and CAP+1 ints a point: at G = 32 in shared memory (one copy a
// point, slot_bytes), at G = 1 in the lane's local memory (a block of 256
// points would need 132 KB of shared memory, and opting in would leave
// one block an SM).  Every later list is a view of the two: the endpoint
// rules' prepend and append, the repair's `filled` (its gaps stored in the
// list that case leaves empty), the case select and the janus rewrite.
// Each loop runs to the counts found, not to P; the phases' bounds, maxima
// and sums are the lane's local arrays, written once per phase found and
// read back when the sink writes the row.  K1's and K2's sink writes it
// with contiguous stores: at G = 32 the warp's lanes take a point's slots
// side by side; at G = 1, where a lane holds a point, the warp's lanes
// put 32 bytes each into a 1 KB tile of shared memory a warp
// (row_tile_bytes) and store each field's rows from there, so a store
// fills whole 32-byte sectors instead of one element of 32 rows.  The
// small body's local traffic at CAP = 64 was O(P^2) a point (its
// all-pairs overlap test alone reads 3 P^2 words); the wide body's is
// O(phases found).

// Tensor cores do not apply: the per-phase sums are masked, shifted dot
// products of length <= N, and no product of matrices exists for wgmma or
// f64 DMMA.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace tail {

constexpr int SMALL = 8;           // phase slots of the first build (max_phases <= 8)
constexpr int WIDE = 64;           // phase slots of the wide build (max_phases <= 64)
constexpr int BIG = 2147483647;    // padding sentinel of the index lists
constexpr int THREADS = 256;       // threads per block, every layout
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;

// One point's lanes: G consecutive lanes of a warp.
template <int G>
struct Group {
  static_assert(G >= 1 && G <= 32 && (G & (G - 1)) == 0, "G must be a power of two dividing 32");
  int lane;       // 0..G-1 within the group
  int base;       // the group's first lane in the warp
  unsigned mask;  // the group's lanes in the warp
};

template <int G>
__device__ __forceinline__ Group<G> group_of(int tid) {
  const int base = tid & 31 & ~(G - 1);
  return Group<G>{tid & (G - 1), base, (FULL >> (32 - G)) << base};
}

// Whether a block keeps its points' index slots (CAP maxima and CAP+1
// minima each) in shared memory: at G = 32 (8 points a block, 4.1 KB at
// CAP 64) and in the small build.  The wide build at G < 32 keeps them in
// each lane's local memory instead: (2 x 64 + 1) x 4 bytes x 256 points is
// 132 KB, more than the 48 KB a block gets without opting in.
__host__ __device__ constexpr bool slots_shared(int G, int CAP) { return G == 32 || CAP <= SMALL; }

// Shared-memory bytes of the index slots of a block of THREADS/G points
// (cuda_sweep.slot_bytes reports the same).
__host__ __device__ constexpr int slot_bytes(int G, int CAP) {
  return slots_shared(G, CAP) ? (2 * CAP + 1) * (int)sizeof(int) * (THREADS / G) : 0;
}

// Shared-memory bytes of the row tile of a block of K1 or K2 (OutSink::row):
// in the wide build at G = 1 each warp stages the rows it writes in 32
// bytes a lane (cuda_sweep.row_tile_bytes reports the same).
constexpr int ROW_TILE = 32 * 32;  // bytes a warp
__host__ __device__ constexpr int row_tile_bytes(int G, int CAP) { return G == 1 && CAP > SMALL ? WARPS * ROW_TILE : 0; }

// Whether a block of THREADS/G points stages `rows` bytes of mu-independent
// rows in shared memory: at G < 32, where they fit beside the index slots
// and `extra` bytes more (K1's and K2's row tile) in the 48 KB a block gets
// without opting in.  At G = 1 every lane of a warp then reads the same
// bin at the same step, a shared-memory broadcast.
template <int G, int CAP>
__host__ __device__ __forceinline__ bool stages_rows(size_t rows, size_t extra = 0) {
  return G < 32 && rows + slot_bytes(G, CAP) + extra <= 48 * 1024;
}

// The block's copy of n doubles from global into shared memory.
__device__ __forceinline__ void stage(double* dst, const double* src, int n) {
  for (int k = threadIdx.x; k < n; k += THREADS) dst[k] = src[k];
}

// A row read: through the read-only cache (NC: the rows in global memory)
// or a plain load (rows a block may have staged in shared memory).
template <bool NC>
__device__ __forceinline__ double ld(const double* p, size_t i) {
  if constexpr (NC) return __ldg(p + i);
  else return p[i];
}

// Where one point's results go: row b of every [B, ...] output.
struct Out {
  double* fe;            // [B, P]
  int* left;             // [B, P]
  int* right;            // [B, P]
  unsigned char* mask;   // [B, P]
  int* n_phases;         // [B]
  unsigned char* valid;  // [B]
  double* n_i;           // [B, P, S]   (props only)
  double* x_i;           // [B, P, S]
  double* ntot;          // [B, P]
  double* u;             // [B, P]
  double* density;       // [B, P]
};

// <N_i> (S of them), N_tot and <U> of one phase from its sums acc (the
// arithmetic of segment.thermo_key_core); a phase without mass divides by 1.
__device__ __forceinline__ void phase_props(const double* acc, int S, double* ni, double& nt, double& u) {
  const double den = acc[0] > 0.0 ? acc[0] : 1.0;
  nt = 0.0;
  for (int s = 0; s < S; ++s) {
    ni[s] = acc[1 + s] / den;
    nt = s == 0 ? ni[s] : nt + ni[s];
  }
  u = acc[1 + S] / den;
}

// One point's row as the wide build hands it to its sink: slot p <
// nmask is a phase (mask set) with bounds (lo[p], hi[p]), shift mpf[p]
// and sums acc[p]; a slot past the count has no mask, fe 0 and the sums
// `fill` (the weight-0 bin N-1), bounds (lo[p], hi[p]) below q_end and
// (BIG, N) from there.
template <int CAP, int KACC>
struct WideRow {
  int nmask, q_end, N;
  const int *lo, *hi;
  double x0;  // x at bin 0
  const double* mpf;
  const double (*acc)[KACC];
  const double* fill;
  __device__ __forceinline__ int left(int p) const { return p < q_end ? lo[p] : BIG; }
  __device__ __forceinline__ int right(int p) const { return p < q_end ? hi[p] : N; }
  __device__ __forceinline__ bool mask(int p) const { return p < nmask; }
  // fe_p = x(0) - m_p - log(sum_p) (segment._fe): +inf without mass
  __device__ __forceinline__ double phase_fe(int p) const {
    if (p >= nmask) return 0.0;
    return acc[p][0] > 0.0 ? x0 - mpf[p] - log(acc[p][0]) : INFINITY;
  }
  __device__ __forceinline__ const double* sums(int p) const { return p < nmask ? acc[p] : fill; }
};

// v[s] for a run-time s < NS, from registers.
template <int NS>
__device__ __forceinline__ double pick(const double* v, int s) {
  double r = v[0];
#pragma unroll
  for (int k = 1; k < NS; ++k)
    if (k == s) r = v[k];
  return r;
}

// The sink of K1 and K2: row b of every [B, ...] output, for at most NS
// species.  It refers to the kernel's Out rather than copying it, so the
// pointers stay in parameter space and out of the register file.
template <int NS>
struct OutSink {
  const Out& o;
  long long b;
  int P, S, props;
  const double* volume;
  unsigned live;         // G = 1: the warp's lanes that hold a point (the wide build's rows)
  unsigned char* tile;   // G = 1: the warp's ROW_TILE bytes (the wide build's rows)

  __device__ __forceinline__ void phase(int p, int left, int right, bool mask, double fe, const double* acc) const {
    const long long ob = b * P;
    o.fe[ob + p] = fe;
    o.left[ob + p] = left;
    o.right[ob + p] = right;
    o.mask[ob + p] = mask ? 1 : 0;
    if (props) {
      double ni[NS], nt, u;
      phase_props(acc, S, ni, nt, u);
      const double nsafe = nt != 0.0 ? nt : 1.0;
      for (int s = 0; s < S; ++s) {
        o.n_i[(ob + p) * S + s] = ni[s];
        o.x_i[(ob + p) * S + s] = ni[s] / nsafe;
      }
      o.u[ob + p] = u;
      o.ntot[ob + p] = nt;
      o.density[ob + p] = nt / *volume;
    }
  }

  __device__ __forceinline__ void finish(int n_phases, bool valid, int) const {
    o.n_phases[b] = n_phases;
    o.valid[b] = valid ? 1 : 0;
  }

  // The wide build's whole row of the point (slots 0..P-1), called on
  // every lane of the group.  At G > 1 the group's lanes write slots side
  // by side, each from its own copy of the row.  At G = 1 the warp's live
  // lanes write their points' rows together, field by field, through the
  // warp's tile: each lane puts its next 32 bytes of the field in the
  // tile, then each store covers consecutive elements of one row, where a
  // lane writing its own row would spend a request on each element.
  static constexpr bool ROW_ON_EVERY_LANE = true;  // row() at G > 1 reads the row on every lane

  template <int G, int CAP, int KACC>
  __device__ __forceinline__ void row(const Group<G>& grp, const WideRow<CAP, KACC>& w) const {
    if constexpr (G > 1) {
      for (int p = grp.lane; p < P; p += G) phase(p, w.left(p), w.right(p), w.mask(p), w.phase_fe(p), w.sums(p));
    } else {
      put(o.fe, P, [&](int p) { return w.phase_fe(p); });
      put(o.left, P, [&](int p) { return w.left(p); });
      put(o.right, P, [&](int p) { return w.right(p); });
      put(o.mask, P, [&](int p) { return (unsigned char)(w.mask(p) ? 1 : 0); });
      if (props) {
        // each phase's <N_i>, N_tot and <U> once (phase_props), and those
        // of a slot past the count, the same for every such slot
        double pr[CAP][NS + 2];
        for (int p = 0; p < w.nmask; ++p) {
          double ni[NS], nt, u;
          phase_props(w.acc[p], S, ni, nt, u);
#pragma unroll
          for (int k = 0; k < NS; ++k) pr[p][k] = ni[k];
          pr[p][NS] = nt;
          pr[p][NS + 1] = u;
        }
        double fni[NS] = {}, fnt, fu;
        phase_props(w.fill, S, fni, fnt, fu);
        const auto nt_of = [&](int p) { return p < w.nmask ? pr[p][NS] : fnt; };
        const auto ni_of = [&](int e) {
          const int p = e / S;
          return p < w.nmask ? pick<NS>(pr[p], e - p * S) : pick<NS>(fni, e - p * S);
        };
        put(o.u, P, [&](int p) { return p < w.nmask ? pr[p][NS + 1] : fu; });
        put(o.ntot, P, nt_of);
        put(o.density, P, [&](int p) { return nt_of(p) / *volume; });
        put(o.n_i, P * S, ni_of);
        put(o.x_i, P * S, [&](int e) {
          const double nt = nt_of(e / S);
          return ni_of(e) / (nt != 0.0 ? nt : 1.0);
        });
      }
    }
  }

  // G = 1: the warp's rows of one [B, R] output, element e of the lane's
  // row val(e), through the warp's tile (32 / sizeof(T) elements a lane a
  // step); every live lane calls it, and all take the same steps.
  template <typename T, typename F>
  __device__ __forceinline__ void put(T* dst, int R, const F& val) const {
    constexpr int C = 32 / (int)sizeof(T);
    T* t = reinterpret_cast<T*>(tile);
    const int lane = threadIdx.x & 31;
    const int rank = __popc(live & ((1u << lane) - 1u)), nl = __popc(live);
    const long long base = (b - lane) * (long long)R;  // the warp's first point's row
    for (int e0 = 0; e0 < R; e0 += C) {
#pragma unroll
      for (int j = 0; j < C; ++j)
        if (e0 + j < R) t[lane * C + j] = val(e0 + j);
      __syncwarp(live);
      for (int k0 = 0; k0 < 32 * C; k0 += nl) {
        const int k = k0 + rank, L = k / C, j = k % C;
        if (k < 32 * C && (live >> L & 1u) && e0 + j < R) dst[base + (long long)L * R + e0 + j] = t[k];
      }
      __syncwarp(live);
    }
  }
};

template <int G>
__device__ __forceinline__ double grp_max(double v, unsigned m) {
  for (int o = G / 2; o; o >>= 1) v = fmax(v, __shfl_xor_sync(m, v, o, G));
  return v;
}

template <int G>
__device__ __forceinline__ double grp_min(double v, unsigned m) {
  for (int o = G / 2; o; o >>= 1) v = fmin(v, __shfl_xor_sync(m, v, o, G));
  return v;
}

template <int G>
__device__ __forceinline__ double grp_sum(double v, unsigned m) {
  for (int o = G / 2; o; o >>= 1) v += __shfl_xor_sync(m, v, o, G);
  return v;
}

// The group's ballot, in its own bits 0..G-1.
template <int G>
__device__ __forceinline__ unsigned grp_ballot(const Group<G>& g, bool p) {
  if constexpr (G == 1) return p ? 1u : 0u;
  else if constexpr (G == 32) return __ballot_sync(FULL, p);
  else return (__ballot_sync(g.mask, p) >> g.base) & (FULL >> (32 - G));
}

template <int G>
__device__ __forceinline__ void grp_sync(const Group<G>& g) {
  if constexpr (G > 1) __syncwarp(g.mask);
}

__device__ __forceinline__ int take(const int* arr, int size, int i) {
  return arr[min(max(i, 0), size - 1)];
}

__device__ __forceinline__ void prepend(int* arr, int size, int val) {
  for (int j = size - 1; j > 0; --j) arr[j] = arr[j - 1];
  arr[0] = val;
}

__device__ __forceinline__ void append_at(int* arr, int size, int& cnt, int val) {
  if (cnt >= 0 && cnt < size) arr[cnt] = val;
  ++cnt;
}

// Group compaction of two flag sets over bins [0, N): the first `nmx`
// (resp. `nmn`) flagged indices in ascending order into the slots 0,
// pitch, 2 pitch, ..., BIG-padded (PAD; the wide build reads a slot past
// the count as BIG instead), and the full counts
// (segment._compress_indices).
template <int G, bool PAD = true, typename Flags>
__device__ void compact2(int N, const Group<G>& grp, Flags flags, int* mx, int nmx, int* mn, int nmn, int pitch, int& cmx,
                         int& cmn) {
  cmx = 0;
  cmn = 0;
  const int lane = grp.lane;
  const unsigned below = (1u << lane) - 1u;
  for (int base = 0; base < N; base += G) {
    const int i = base + lane;
    bool is_max = false, is_min = false;
    if (i < N) flags(i, is_max, is_min);
    const unsigned bmx = grp_ballot(grp, is_max);
    const unsigned bmn = grp_ballot(grp, is_min);
    if (is_max) {
      const int r = cmx + __popc(bmx & below);
      if (r < nmx) mx[r * pitch] = i;
    }
    if (is_min) {
      const int r = cmn + __popc(bmn & below);
      if (r < nmn) mn[r * pitch] = i;
    }
    cmx += __popc(bmx);
    cmn += __popc(bmn);
  }
  if constexpr (PAD) {
    for (int r = lane; r < nmx; r += G)
      if (r >= cmx) mx[r * pitch] = BIG;
    for (int r = lane; r < nmn; r += G)
      if (r >= cmn) mn[r * pitch] = BIG;
  }
  grp_sync(grp);
}

// The small build's tail (CAP <= SMALL) for one point: every stage copies
// the index lists into the lane's own arrays and runs to P (see the header).
template <int CAP, int KACC, int G, typename XF, typename KF, typename Sink>
__device__ void thermo_point_small(const XF& xf, const KF& kf, const Group<G>& grp, int N, int S, int P, int smooth, int props,
                             int janus, Sink& sink, int* s_mx, int* s_mn, int pitch) {
  const int lane = grp.lane;
  const unsigned gm = grp.mask;
  const int last = N - 1;

  // ---- stencil flags + compaction (segment.stencil_flags) ----
  int n_max0, n_min0;
  compact2(N, grp, [&](int i, bool& is_max, bool& is_min) {
    const double xi = xf(i);
    bool mx = true, mn = true;
    for (int k = 1; k <= smooth && (mx || mn); ++k) {
      const double up = xf(min(i + k, last));
      const double dn = xf(max(i - k, 0));
      mx = mx && xi > up && xi > dn;
      mn = mn && xi < up && xi < dn;
    }
    is_max = mx;
    is_min = mn;
  }, s_mx, P, s_mn, P + 1, pitch, n_max0, n_min0);

  const bool has_max = n_max0 > 0, has_min = n_min0 > 0;
  const bool none_case = !has_max && !has_min;
  const bool max_only = has_max && !has_min;
  const bool min_only = has_min && !has_max;

  if (none_case) {
    // straight-line fallback (gc_hist.pyx:382-386): every bin equal to the
    // global max / min, first-P truncated with the full count
    double gmx = -INFINITY, gmn = INFINITY;
    for (int i = lane; i < N; i += G) {
      const double xi = xf(i);
      gmx = fmax(gmx, xi);
      gmn = fmin(gmn, xi);
    }
    gmx = grp_max<G>(gmx, gm);
    gmn = grp_min<G>(gmn, gm);
    compact2(N, grp, [&](int i, bool& is_max, bool& is_min) {
      const double xi = xf(i);
      is_max = xi == gmx;
      is_min = xi == gmn;
    }, s_mx, P, s_mn, P + 1, pitch, n_max0, n_min0);
  }

  int mx0[CAP], mn0[CAP + 1];
  for (int j = 0; j < P; ++j) mx0[j] = s_mx[j * pitch];
  for (int j = 0; j <= P; ++j) mn0[j] = s_mn[j * pitch];

  // ---- over-smoothing repair gaps (gc_hist.pyx:352-381): first arg-max
  // (max-only: arg-min of -x is the minimum) of the non-found kind between
  // consecutive found anchors; an empty gap reads 0 ----
  int anchor[CAP + 1];
  int gap[CAP];
  const int n_anchor = max_only ? n_max0 : n_min0;
  for (int j = 0; j <= P; ++j) anchor[j] = max_only ? (j < P ? mx0[j] : BIG) : mn0[j];
  if (max_only || min_only) {
    const double sgn = max_only ? 1.0 : -1.0;
    for (int q = 0; q + 1 < P; ++q) {
      const int hi = min(anchor[q + 1], N);
      double bv = INFINITY;
      int bi = BIG;
      // anchors are bins or BIG: clamp before adding the lane offset
      for (int i = min(anchor[q], N) + lane; i < hi; i += G) {
        const double v = sgn * xf(i);
        if (v < bv) {
          bv = v;
          bi = i;
        }
      }
      for (int off = G / 2; off; off >>= 1) {
        const double ov = __shfl_xor_sync(gm, bv, off, G);
        const int oi = __shfl_xor_sync(gm, bi, off, G);
        if (ov < bv || (ov == bv && oi < bi)) {
          bv = ov;
          bi = oi;
        }
      }
      gap[q] = bi == BIG ? 0 : bi;
    }
  }

  // ---- scalar segmentation logic, identical on every lane of the group ----
  // both-found endpoint rules (gc_hist.pyx:333-351)
  int bmx[CAP], bmn[CAP + 1];
  int bnmax = n_max0, bnmin = n_min0;
  for (int j = 0; j < P; ++j) bmx[j] = mx0[j];
  for (int j = 0; j <= P; ++j) bmn[j] = mn0[j];
  const bool zero_in = bmx[0] == 0 || bmn[0] == 0;
  const bool pre_min = !zero_in && bmx[0] < bmn[0];
  const bool pre_max = !zero_in && bmx[0] > bmn[0];
  bool validB = zero_in || pre_min || pre_max;
  if (pre_min) { prepend(bmn, P + 1, 0); ++bnmin; }
  if (pre_max) { prepend(bmx, P, 0); ++bnmax; }
  const int last_mx = take(bmx, P, bnmax - 1);
  const int last_mn = take(bmn, P + 1, bnmin - 1);
  const bool last_in = last_mx == last || last_mn == last;
  const bool app_max = !last_in && last_mx < last_mn;
  const bool app_min = !last_in && last_mx > last_mn;
  validB = validB && (last_in || app_max || app_min);
  if (app_max) append_at(bmx, P, bnmax, last);
  if (app_min) append_at(bmn, P + 1, bnmin, last);

  int filled[CAP + 1];
  for (int s = 0; s <= P; ++s) {
    int v = s == 0 ? 0 : BIG;
    if (P > 1 && s >= 1 && s <= n_anchor - 1) v = gap[min(max(s - 1, 0), P - 2)];
    if (s == n_anchor) v = last;
    filled[s] = v;
  }

  // select per case (exclusive)
  const bool raw_max = max_only || none_case;
  const bool raw_min = min_only || none_case;
  int emx[CAP], emn[CAP + 1];
  int enmax, enmin;
  for (int j = 0; j < P; ++j) emx[j] = min_only ? filled[j] : (raw_max ? mx0[j] : bmx[j]);
  enmax = min_only ? n_anchor + 1 : (raw_max ? n_max0 : bnmax);
  for (int j = 0; j <= P; ++j) emn[j] = max_only ? filled[j] : (raw_min ? mn0[j] : bmn[j]);
  enmin = max_only ? n_anchor + 1 : (raw_min ? n_min0 : bnmin);
  bool valid = (max_only || min_only || none_case) ? true : validB;

  // alternation + ordering checks (gc_hist.pyx:402-415)
  valid = valid && abs(enmax - enmin) <= 1;
  valid = valid && enmax <= P && enmin <= P + 1 && enmax >= 1;
  {
    const bool max_first = emx[0] < emn[0];
    const int total = enmax + enmin;
    int prev = 0;
    for (int s = 0; s < 2 * (P + 1); ++s) {
      const int smax = emx[min(s / 2, P - 1)];
      const int smin = emn[s / 2];
      const int cur = (s % 2 == 0) ? (max_first ? smax : smin) : (max_first ? smin : smax);
      if (s >= 1 && s < total && cur < prev) valid = false;
      prev = cur;
    }
  }

  // janus collect (collect.py:32-80)
  if (janus) {
    const int nm1 = enmax - 1;
    long long msum = 0;
    for (int j = 0; j < P; ++j)
      if (j < nm1) msum += emx[j];
    const int mean = (int)rint((double)msum / (double)max(nm1, 1));  // half to even
    const int mx_last = take(emx, P, nm1);
    const bool lead = emn[0] == 0;
    const int jl_mn = take(emn, P + 1, enmin - 1);
    const int jp_mn = take(emn, P + 1, enmin - 2);
    const bool mid = mean < jl_mn && jl_mn < mx_last;
    const bool tail = jl_mn > mx_last;
    const bool apply = enmax > 2;
    valid = valid && (!apply || !tail || enmin > 1);
    if (apply) {
      int nmn[CAP + 1];
      int cnt = 0;
      for (int j = 0; j <= P; ++j) nmn[j] = BIG;
      if (lead) append_at(nmn, P + 1, cnt, 0);
      if (mid) append_at(nmn, P + 1, cnt, jl_mn);
      if (tail) {
        append_at(nmn, P + 1, cnt, jp_mn);
        append_at(nmn, P + 1, cnt, jl_mn);
      }
      for (int j = 0; j < P; ++j) emx[j] = j == 0 ? mean : (j == 1 ? mx_last : BIG);
      for (int j = 0; j <= P; ++j) emn[j] = nmn[j];
      enmax = 2;
      enmin = cnt;
    }
  }

  // phase bounds: the running minima counter (gc_hist.pyx:498-520)
  int lo[CAP], hi[CAP];
  bool msk[CAP];
  {
    const bool s0 = emx[0] == 0;
    for (int p = 0; p < P; ++p) {
      const int left_v = s0 ? emn[p == 0 ? 0 : p - 1] : emn[p];
      const int right_v = s0 ? emn[p] : emn[p + 1];
      int l = emx[p] > 0 ? left_v : 0;
      int r = emx[p] < last ? right_v : N;
      if (r == last) r = N;
      lo[p] = l;
      hi[p] = r;
      msk[p] = p < enmax;
    }
  }

  // ---- per-phase maxima (the per-phase shifts) ----
  double mpf[CAP];
  for (int p = 0; p < P; ++p) {
    double m = -INFINITY;
    if (msk[p]) {
      const int e = min(hi[p], N);
      for (int i = min(max(lo[p], 0), N) + lane; i < e; i += G) m = fmax(m, xf(i));
      m = grp_max<G>(m, gm);
    }
    mpf[p] = isfinite(m) ? m : 0.0;
  }

  // ---- per-phase sums of exp(x - shift) * [1, key rows] ----
  const double xlast = xf(last);
  const double x0 = xf(0);
  const int K = props ? S + 2 : 1;
  for (int p = 0; p < P; ++p) {
    double acc[KACC] = {};
    if (msk[p]) {
      const int b0 = min(max(lo[p], 0), N);
      const int e = min(hi[p], last);  // bin N-1 is added per phase below
      // At G < 32 a phase that shares no bin of [b0, e) with another
      // masked phase takes its own shift in every bin (the usual case),
      // which keeps the per-point arrays out of the loop below.
      bool shared = G == 32;
      if constexpr (G < 32)
        for (int q = 0; q < P; ++q)
          shared = shared || (q != p && msk[q] && max(lo[q], b0) < min(hi[q], e));
      for (int i = b0 + lane; i < e; i += G) {
        // a bin takes the largest shift of the phases that cover it
        double sh = mpf[p];
        if (shared) {
          sh = -INFINITY;
          for (int q = 0; q < P; ++q)
            if (msk[q] && lo[q] <= i && i < hi[q]) sh = fmax(sh, mpf[q]);
        }
        const double w = exp(xf(i) - sh);
        acc[0] += w;
#pragma unroll
        for (int k = 1; k < KACC; ++k)
          if (k < K) acc[k] += w * kf(k - 1, i);
      }
#pragma unroll
      for (int k = 0; k < KACC; ++k)
        if (k < K) acc[k] = grp_sum<G>(acc[k], gm);
    }
    // bin N-1 with this phase's own shift (the endpoint-overlap rule)
    const bool in_last = msk[p] && lo[p] <= last && last < hi[p];
    const double el = in_last ? exp(xlast - mpf[p]) : 0.0;
    acc[0] += el;
#pragma unroll
    for (int k = 1; k < KACC; ++k)
      if (k < K) acc[k] += el * kf(k - 1, last);

    if (lane == 0) {
      const double wsum = acc[0];
      const bool pos = wsum > 0.0;
      const double fe = x0 - mpf[p] - log(pos ? wsum : 1.0);
      sink.phase(p, lo[p], hi[p], msk[p], (msk[p] && pos) ? fe : (msk[p] ? INFINITY : 0.0), acc);
    }
  }
  if (lane == 0) sink.finish(enmax, valid, take(emx, P, enmax - 1));
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) { return min(max(v, lo), hi); }

// The wide build's tail (CAP > SMALL) for one point: the same outputs, bit
// for bit, as thermo_point_small would write at this CAP.  The point keeps
// only the two compacted lists (s_mx, s_mn; a slot at or past its count
// reads BIG); every later list (the endpoint rules' prepend and append,
// the repair's `filled`, the case select, the janus rewrite) is a view of
// them, so no stage copies a list, and they are read once, before the bin
// loops, into the bounds of each slot the row needs.  Every loop runs to
// the counts found, not to P; the overlap test is O(phases) (below); the
// row goes to sink.row whole (WideRow), on every lane of the group.
template <int CAP, int KACC, int G, typename XF, typename KF, typename Sink>
__device__ void thermo_point_wide(const XF& xf, const KF& kf, const Group<G>& grp, int N, int S, int P, int smooth, int props,
                                  int janus, Sink& sink, int* s_mx, int* s_mn, int pitch) {
  const int lane = grp.lane;
  const unsigned gm = grp.mask;
  const int last = N - 1;

  // ---- stencil flags + compaction (segment.stencil_flags) ----
  int n_max0, n_min0;
  compact2<G, false>(N, grp, [&](int i, bool& is_max, bool& is_min) {
    const double xi = xf(i);
    bool mx = true, mn = true;
    for (int k = 1; k <= smooth && (mx || mn); ++k) {
      const double up = xf(min(i + k, last));
      const double dn = xf(max(i - k, 0));
      mx = mx && xi > up && xi > dn;
      mn = mn && xi < up && xi < dn;
    }
    is_max = mx;
    is_min = mn;
  }, s_mx, P, s_mn, P + 1, pitch, n_max0, n_min0);

  const bool has_max = n_max0 > 0, has_min = n_min0 > 0;
  const bool none_case = !has_max && !has_min;
  const bool max_only = has_max && !has_min;
  const bool min_only = has_min && !has_max;

  if (none_case) {
    // straight-line fallback (gc_hist.pyx:382-386)
    double gmx = -INFINITY, gmn = INFINITY;
    for (int i = lane; i < N; i += G) {
      const double xi = xf(i);
      gmx = fmax(gmx, xi);
      gmn = fmin(gmn, xi);
    }
    gmx = grp_max<G>(gmx, gm);
    gmn = grp_min<G>(gmn, gm);
    compact2<G, false>(N, grp, [&](int i, bool& is_max, bool& is_min) {
      const double xi = xf(i);
      is_max = xi == gmx;
      is_min = xi == gmn;
    }, s_mx, P, s_mn, P + 1, pitch, n_max0, n_min0);
  }

  // the compacted lists, BIG past their counts (mx0: P slots, mn0: P+1)
  const int cmx = min(n_max0, P), cmn = min(n_min0, P + 1);
  const auto mx0 = [&](int j) { return j < cmx ? s_mx[j * pitch] : BIG; };
  const auto mn0 = [&](int j) { return j < cmn ? s_mn[j * pitch] : BIG; };

  // ---- over-smoothing repair gaps (gc_hist.pyx:352-381), as the small
  // build, for the gaps `filled` reads; a max-only point has no minima and
  // a min-only one no maxima, so the gaps go to the list it left empty ----
  const int n_anchor = max_only ? n_max0 : n_min0;
  int* gap = max_only ? s_mn : s_mx;
  if (max_only || min_only) {
    const auto anchor = [&](int j) { return max_only ? (j < P ? mx0(j) : BIG) : mn0(j); };
    const double sgn = max_only ? 1.0 : -1.0;
    const int n_gap = min(P - 1, n_anchor - 1);
    for (int q = 0; q < n_gap; ++q) {
      const int hi = min(anchor(q + 1), N);
      double bv = INFINITY;
      int bi = BIG;
      for (int i = min(anchor(q), N) + lane; i < hi; i += G) {
        const double v = sgn * xf(i);
        if (v < bv) {
          bv = v;
          bi = i;
        }
      }
      for (int off = G / 2; off; off >>= 1) {
        const double ov = __shfl_xor_sync(gm, bv, off, G);
        const int oi = __shfl_xor_sync(gm, bi, off, G);
        if (ov < bv || (ov == bv && oi < bi)) {
          bv = ov;
          bi = oi;
        }
      }
      if (lane == 0) gap[q * pitch] = bi == BIG ? 0 : bi;
    }
    grp_sync(grp);
  }
  const auto filled = [&](int s) {
    int v = s == 0 ? 0 : BIG;
    if (P > 1 && s >= 1 && s <= n_anchor - 1) v = gap[clampi(s - 1, 0, P - 2) * pitch];
    if (s == n_anchor) v = last;
    return v;
  };

  // ---- both-found endpoint rules (gc_hist.pyx:333-351): prepend and
  // append as views of mx0 / mn0 ----
  const bool zero_in = mx0(0) == 0 || mn0(0) == 0;
  const bool pre_min = !zero_in && mx0(0) < mn0(0);
  const bool pre_max = !zero_in && mx0(0) > mn0(0);
  bool validB = zero_in || pre_min || pre_max;
  int bnmax = n_max0 + (pre_max ? 1 : 0), bnmin = n_min0 + (pre_min ? 1 : 0);
  const auto bmx_pre = [&](int j) { return pre_max ? (j == 0 ? 0 : mx0(j - 1)) : mx0(j); };
  const auto bmn_pre = [&](int j) { return pre_min ? (j == 0 ? 0 : mn0(j - 1)) : mn0(j); };
  const int last_mx = bmx_pre(clampi(bnmax - 1, 0, P - 1));
  const int last_mn = bmn_pre(clampi(bnmin - 1, 0, P));
  const bool last_in = last_mx == last || last_mn == last;
  const bool app_max = !last_in && last_mx < last_mn;
  const bool app_min = !last_in && last_mx > last_mn;
  validB = validB && (last_in || app_max || app_min);
  const int at_mx = bnmax, at_mn = bnmin;  // where append_at writes (a slot < P resp. P+1)
  if (app_max) ++bnmax;
  if (app_min) ++bnmin;
  const auto bmx = [&](int j) { return app_max && j == at_mx ? last : bmx_pre(j); };
  const auto bmn = [&](int j) { return app_min && j == at_mn ? last : bmn_pre(j); };

  // select per case (exclusive)
  const bool raw_max = max_only || none_case;
  const bool raw_min = min_only || none_case;
  const auto emx0 = [&](int j) { return min_only ? filled(j) : (raw_max ? mx0(j) : bmx(j)); };
  const auto emn0 = [&](int j) { return max_only ? filled(j) : (raw_min ? mn0(j) : bmn(j)); };
  int enmax = min_only ? n_anchor + 1 : (raw_max ? n_max0 : bnmax);
  int enmin = max_only ? n_anchor + 1 : (raw_min ? n_min0 : bnmin);
  bool valid = (max_only || min_only || none_case) ? true : validB;

  // alternation + ordering checks (gc_hist.pyx:402-415); only steps
  // 1..total-1 can clear valid, and once it is false nothing sets it again
  valid = valid && abs(enmax - enmin) <= 1;
  valid = valid && enmax <= P && enmin <= P + 1 && enmax >= 1;
  if (valid) {
    const bool max_first = emx0(0) < emn0(0);
    const int steps = min(enmax + enmin, 2 * (P + 1));
    int prev = 0;
    for (int s = 0; s < steps; ++s) {
      const int smax = emx0(min(s / 2, P - 1));
      const int smin = emn0(s / 2);
      const int cur = (s % 2 == 0) ? (max_first ? smax : smin) : (max_first ? smin : smax);
      if (s >= 1 && cur < prev) valid = false;
      prev = cur;
    }
  }

  // janus collect (collect.py:32-80): two maxima and at most three minima
  bool jan = false;
  int j_mean = 0, j_last = 0, jn0 = BIG, jn1 = BIG, jn2 = BIG, jcnt = 0;
  if (janus) {
    const int nm1 = enmax - 1;
    long long msum = 0;
    for (int j = 0; j < min(P, nm1); ++j) msum += emx0(j);
    j_mean = (int)rint((double)msum / (double)max(nm1, 1));  // half to even
    j_last = emx0(clampi(nm1, 0, P - 1));
    const bool lead = emn0(0) == 0;
    const int jl_mn = emn0(clampi(enmin - 1, 0, P));
    const int jp_mn = emn0(clampi(enmin - 2, 0, P));
    const bool mid = j_mean < jl_mn && jl_mn < j_last;
    const bool tail = jl_mn > j_last;
    jan = enmax > 2;
    valid = valid && (!jan || !tail || enmin > 1);
    if (jan) {
      const auto push = [&](int v) {
        if (jcnt == 0) jn0 = v;
        else if (jcnt == 1) jn1 = v;
        else if (jcnt < P + 1) jn2 = v;
        ++jcnt;
      };
      if (lead) push(0);
      if (mid) push(jl_mn);
      if (tail) {
        push(jp_mn);
        push(jl_mn);
      }
      enmax = 2;
      enmin = jcnt;
    }
  }
  const auto emx = [&](int j) { return jan ? (j == 0 ? j_mean : (j == 1 ? j_last : BIG)) : emx0(j); };
  const auto emn = [&](int j) { return jan ? (j == 0 ? jn0 : (j == 1 ? jn1 : (j == 2 ? jn2 : BIG))) : emn0(j); };

  // phase bounds: the running minima counter (gc_hist.pyx:498-520)
  const bool s0 = emx(0) == 0;
  const auto bounds = [&](int p, int& l, int& r) {
    const int mxp = emx(p);
    const int left_v = s0 ? emn(p == 0 ? 0 : p - 1) : emn(p);
    const int right_v = s0 ? emn(p) : emn(p + 1);
    l = mxp > 0 ? left_v : 0;
    r = mxp < last ? right_v : N;
    if (r == last) r = N;
  };
  const int nmask = clampi(enmax, 0, P);  // the masked slots: p < enmax
  const int last_max = emx(clampi(enmax - 1, 0, P - 1));
  // a slot past the count has no maximum (emx BIG): its right bound is N
  // and its left the minimum before it, BIG once the minima run out.
  // q_end starts the run of such slots up to P (WideRow::left, right)
  int q_end = P;
  for (; q_end > nmask; --q_end) {
    int l, r;
    bounds(q_end - 1, l, r);
    if (l != BIG || r != N) break;
  }

  // ---- the bounds of slots 0..q_end-1 (the views end here), the masked
  // phases' maxima (the per-phase shifts), and whether their left bounds
  // ascend ----
  int lo[CAP], hi[CAP];
  for (int p = 0; p < q_end; ++p) bounds(p, lo[p], hi[p]);
  double mpf[CAP];
  double sums[CAP][KACC];  // each phase's sums, for the row
  bool ascending = true;
  for (int p = 0; p < nmask; ++p) {
    const int l = lo[p], r = hi[p];
    ascending = ascending && (p == 0 || l >= lo[p - 1]);
    double m = -INFINITY;
    const int e = min(r, N);
    for (int i = min(max(l, 0), N) + lane; i < e; i += G) m = fmax(m, xf(i));
    m = grp_max<G>(m, gm);
    mpf[p] = isfinite(m) ? m : 0.0;
  }

  // ---- per-phase sums of exp(x - shift) * [1, key rows] ----
  const double xlast = xf(last);
  const double x0 = xf(0);
  const int K = props ? S + 2 : 1;
  // Whether another phase q covers a bin of p's [b0, e) (then each bin
  // takes the largest shift of the phases that cover it).  The small
  // build tests every pair.  Left bounds are >= 0, and with b0 < e, b0 is
  // p's left; when the left bounds ascend, a phase q < p (left <= b0)
  // meets [b0, e) iff its right > b0, and a phase q > p (left >= b0) iff
  // it is not empty and its left < e.  So the largest right before p and
  // the left of the first non-empty phase after p decide it.
  int pre_r = -1;              // the largest right of the phases before p
  int nx = 0, nx_l = 0;        // the first non-empty phase after p, its left
  for (int p = 0; p < nmask; ++p) {
    const int l = lo[p], r = hi[p];
    double acc[KACC] = {};
    const int b0 = min(max(l, 0), N);
    const int e = min(r, last);  // bin N-1 is added per phase below
    if (b0 < e) {
      bool shared;
      if (ascending) {
        if (nx <= p) {
          for (nx = p + 1; nx < nmask; ++nx)
            if (lo[nx] < hi[nx]) {
              nx_l = lo[nx];
              break;
            }
        }
        shared = pre_r > b0 || (nx < nmask && nx_l < e);
      } else {
        shared = false;
        for (int q = 0; q < nmask; ++q) shared = shared || (q != p && max(lo[q], b0) < min(hi[q], e));
      }
      for (int i = b0 + lane; i < e; i += G) {
        double sh = mpf[p];
        if (shared) {
          sh = -INFINITY;
          for (int q = 0; q < nmask; ++q)
            if (lo[q] <= i && i < hi[q]) sh = fmax(sh, mpf[q]);
        }
        const double w = exp(xf(i) - sh);
        acc[0] += w;
#pragma unroll
        for (int k = 1; k < KACC; ++k)
          if (k < K) acc[k] += w * kf(k - 1, i);
      }
    }
#pragma unroll
    for (int k = 0; k < KACC; ++k)
      if (k < K) acc[k] = grp_sum<G>(acc[k], gm);
    // bin N-1 with this phase's own shift (the endpoint-overlap rule)
    const bool in_last = l <= last && last < r;
    const double el = in_last ? exp(xlast - mpf[p]) : 0.0;
    acc[0] += el;
#pragma unroll
    for (int k = 1; k < KACC; ++k)
      if (k < K) acc[k] += el * kf(k - 1, last);
    if (Sink::ROW_ON_EVERY_LANE || lane == 0)
#pragma unroll
      for (int k = 0; k < KACC; ++k) sums[p][k] = acc[k];
    pre_r = max(pre_r, r);
  }

  // ---- the slots past the count: no sums, bin N-1 at weight 0 ----
  double fill[KACC] = {};
#pragma unroll
  for (int k = 1; k < KACC; ++k)
    if (k < K) fill[k] += 0.0 * kf(k - 1, last);
  sink.row(grp, WideRow<CAP, KACC>{nmask, q_end, N, lo, hi, x0, mpf, sums, fill});
  if (lane == 0) sink.finish(enmax, valid, last_max);
}

// The whole tail for one point, run by the G lanes of `grp`, for P <= CAP
// phase slots and K = (props ? S + 2 : 1) <= KACC sums; results go to
// `sink` (see the header), from the group's first lane, and in the wide
// build the fill of the slots past the count from the whole group (at G =
// 1 from the warp's live lanes).  s_mx and s_mn are the point's slots of
// CAP and CAP+1 ints, `pitch` apart.
template <int CAP, int KACC, int G, typename XF, typename KF, typename Sink>
__device__ __forceinline__ void thermo_point(const XF& xf, const KF& kf, const Group<G>& grp, int N, int S, int P, int smooth,
                                             int props, int janus, Sink& sink, int* s_mx, int* s_mn, int pitch) {
  if constexpr (CAP <= SMALL)
    thermo_point_small<CAP, KACC>(xf, kf, grp, N, S, P, smooth, props, janus, sink, s_mx, s_mn, pitch);
  else
    thermo_point_wide<CAP, KACC>(xf, kf, grp, N, S, P, smooth, props, janus, sink, s_mx, s_mn, pitch);
}

}  // namespace tail
