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
// maxima (after the janus collect).  K1 and K2 pass OutSink, which writes
// the [B, P] output rows; K3 keeps only the most stable phase.
// phase_props is the arithmetic both use.
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
// segmentation compares x values only and does not.  The per-point index
// arrays stay in local memory at every G and capacity: unrolling their
// loops so that they live in registers took K2 at G = 1 from 93 to 180
// registers and made it 40% slower (PERF.md).  At CAP = 64 they make a
// 2.1-4.3 KB stack frame a lane (ptxas), of which a run touches ~2P+1
// entries an array; the wide build's time then grows with P, and at G =
// 32 every lane of a point keeps its own copy, so the wide builds run one
// lane per point from far fewer points (cuda_sweep.G1_PER_SM_CAP_WIDE).
// One copy per point in shared memory at G = 32 would need one writing
// lane and a warp barrier around every in-place update (prepend, the janus
// rewrite), since the lanes of a group run the scalar logic independently;
// it is not built (PERF.md).
//
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

// Whether a block of THREADS/G points stages `rows` bytes of mu-independent
// rows in shared memory: at G < 32, where they fit beside the index slots
// in the 48 KB a block gets without opting in.  At G = 1 every lane of a
// warp then reads the same bin at the same step, a shared-memory broadcast.
template <int G, int CAP>
__host__ __device__ __forceinline__ bool stages_rows(size_t rows) {
  return G < 32 && rows + slot_bytes(G, CAP) <= 48 * 1024;
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

// The sink of K1 and K2: row b of every [B, ...] output, for at most NS
// species.  It refers to the kernel's Out rather than copying it, so the
// pointers stay in parameter space and out of the register file.
template <int NS>
struct OutSink {
  const Out& o;
  long long b;
  int P, S, props;
  const double* volume;

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
// (resp. `nmn`) flagged indices in ascending order into shared memory at
// slots 0, pitch, 2 pitch, ..., BIG-padded, and the full counts
// (segment._compress_indices).
template <int G, typename Flags>
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
  for (int r = lane; r < nmx; r += G)
    if (r >= cmx) mx[r * pitch] = BIG;
  for (int r = lane; r < nmn; r += G)
    if (r >= cmn) mn[r * pitch] = BIG;
  grp_sync(grp);
}

// The whole tail for one point, run by the G lanes of `grp`, for P <= CAP
// phase slots and K = (props ? S + 2 : 1) <= KACC sums; results go to
// `sink` (see the header), from the group's first lane.  s_mx and s_mn are
// the point's slots of CAP and CAP+1 ints, `pitch` apart.
template <int CAP, int KACC, int G, typename XF, typename KF, typename Sink>
__device__ void thermo_point(const XF& xf, const KF& kf, const Group<G>& grp, int N, int S, int P, int smooth, int props,
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

}  // namespace tail
