// The segmentation + per-phase integration tail shared by the sweep kernels.
//
// The counterpart of the TPU kernels' shared stage
// fhmcanalysis_tpu/core/pallas_sweep.py thermo_lanes: given one state
// point's reweighted (and possibly extrapolated) surface x(i) and its key
// moment rows key_k(i), one warp computes
//
//   smooth-window extrema flags, compacted to the first P maxima / P+1 minima
//   endpoint rules, over-smoothing repair, alternation checks, janus collect
//   phase bounds, per-phase max m_p, per-phase sums of exp(x - m_p) * key
//   with bin N-1 added per phase, then fe, <N_i>, <U>, N_tot, x_i, density
//
// with the float64 semantics of the plain version, fhmcanalysis_torch/core/
// segment.py.  The caller says how x and the key rows are read: `xf(i)`
// returns x at bin i and `kf(k, i)` key row k (0..S) at bin i, both
// recomputed wherever they are needed rather than staged, so the tail has no
// shared-memory limit in N.  Segmentation compares x values exactly, so a
// caller must form x bit-identically to its plain version (__dmul_rn /
// __dadd_rn, and the library built with -fmad=false).
//
// The caller also says where the results go: a sink whose phase(p, left,
// right, mask, fe, acc) is called on lane 0 once per phase slot p =
// 0..P-1, with acc = [sum w, sum w key_0 .. key_S] the phase's sums
// (props only), and whose finish(n_max, valid, last_max) is called on lane 0
// at the end with the final count and last index of the maxima (after the
// janus collect).  K1 and
// K2 pass OutSink, which writes the [B, P] output rows; K3 keeps only the
// most stable phase.  phase_props is the arithmetic both use.
//
// The layout keeps every bin-parallel stage on the 32 lanes of the warp
// (stencil, ballot compaction, arg-min gap scans, max and sum reductions)
// and runs the short data-dependent repair logic, over at most 2P+1
// indices, redundantly on every lane, so no lane waits for a broadcast.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace tail {

constexpr int MAXP = 8;            // largest max_phases the tail holds
constexpr int BIG = 2147483647;    // padding sentinel of the index lists
constexpr int WARPS = 8;           // state points per block
constexpr unsigned FULL = 0xffffffffu;

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

// The sink of K1 and K2: row b of every [B, ...] output.  It refers to the
// kernel's Out rather than copying it, so the pointers stay in parameter
// space and out of the register file.
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
      double ni[2], nt, u;
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

__device__ __forceinline__ double warp_max(double v) {
  for (int o = 16; o; o >>= 1) v = fmax(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

__device__ __forceinline__ double warp_min(double v) {
  for (int o = 16; o; o >>= 1) v = fmin(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

__device__ __forceinline__ double warp_sum(double v) {
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
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

// Warp compaction of two flag sets over bins [0, N): the first `nmx`
// (resp. `nmn`) flagged indices in ascending order into shared memory,
// BIG-padded, and the full counts (segment._compress_indices).
template <typename Flags>
__device__ void compact2(int N, int lane, Flags flags, int* mx, int nmx, int* mn, int nmn, int& cmx, int& cmn) {
  cmx = 0;
  cmn = 0;
  const unsigned below = (1u << lane) - 1u;
  for (int base = 0; base < N; base += 32) {
    const int i = base + lane;
    bool is_max = false, is_min = false;
    if (i < N) flags(i, is_max, is_min);
    const unsigned bmx = __ballot_sync(FULL, is_max);
    const unsigned bmn = __ballot_sync(FULL, is_min);
    if (is_max) {
      const int r = cmx + __popc(bmx & below);
      if (r < nmx) mx[r] = i;
    }
    if (is_min) {
      const int r = cmn + __popc(bmn & below);
      if (r < nmn) mn[r] = i;
    }
    cmx += __popc(bmx);
    cmn += __popc(bmn);
  }
  for (int r = lane; r < nmx; r += 32)
    if (r >= cmx) mx[r] = BIG;
  for (int r = lane; r < nmn; r += 32)
    if (r >= cmn) mn[r] = BIG;
  __syncwarp();
}

// The whole tail for one point, run by all 32 lanes of one warp; results
// go to `sink` (see the header).  s_mx and s_mn are this warp's shared
// scratch of MAXP and MAXP+1 ints.
template <typename XF, typename KF, typename Sink>
__device__ void thermo_point(const XF& xf, const KF& kf, int lane, int N, int S, int P, int smooth, int props,
                             int janus, Sink& sink, int* s_mx, int* s_mn) {
  const int last = N - 1;

  // ---- stencil flags + compaction (segment.stencil_flags) ----
  int n_max0, n_min0;
  compact2(N, lane, [&](int i, bool& is_max, bool& is_min) {
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
  }, s_mx, P, s_mn, P + 1, n_max0, n_min0);

  const bool has_max = n_max0 > 0, has_min = n_min0 > 0;
  const bool none_case = !has_max && !has_min;
  const bool max_only = has_max && !has_min;
  const bool min_only = has_min && !has_max;

  if (none_case) {
    // straight-line fallback (gc_hist.pyx:382-386): every bin equal to the
    // global max / min, first-P truncated with the full count
    double gmx = -INFINITY, gmn = INFINITY;
    for (int i = lane; i < N; i += 32) {
      const double xi = xf(i);
      gmx = fmax(gmx, xi);
      gmn = fmin(gmn, xi);
    }
    gmx = warp_max(gmx);
    gmn = warp_min(gmn);
    compact2(N, lane, [&](int i, bool& is_max, bool& is_min) {
      const double xi = xf(i);
      is_max = xi == gmx;
      is_min = xi == gmn;
    }, s_mx, P, s_mn, P + 1, n_max0, n_min0);
  }

  int mx0[MAXP], mn0[MAXP + 1];
  for (int j = 0; j < P; ++j) mx0[j] = s_mx[j];
  for (int j = 0; j <= P; ++j) mn0[j] = s_mn[j];

  // ---- over-smoothing repair gaps (gc_hist.pyx:352-381): first arg-max
  // (max-only: arg-min of -x is the minimum) of the non-found kind between
  // consecutive found anchors; an empty gap reads 0 ----
  int anchor[MAXP + 1];
  int gap[MAXP];
  const int n_anchor = max_only ? n_max0 : n_min0;
  for (int j = 0; j <= P; ++j) anchor[j] = max_only ? (j < P ? mx0[j] : BIG) : mn0[j];
  if (max_only || min_only) {
    const double sgn = max_only ? 1.0 : -1.0;
    for (int q = 0; q + 1 < P; ++q) {
      const int hi = min(anchor[q + 1], N);
      double bv = INFINITY;
      int bi = BIG;
      // anchors are bins or BIG: clamp before adding the lane offset
      for (int i = min(anchor[q], N) + lane; i < hi; i += 32) {
        const double v = sgn * xf(i);
        if (v < bv) {
          bv = v;
          bi = i;
        }
      }
      for (int off = 16; off; off >>= 1) {
        const double ov = __shfl_xor_sync(FULL, bv, off);
        const int oi = __shfl_xor_sync(FULL, bi, off);
        if (ov < bv || (ov == bv && oi < bi)) {
          bv = ov;
          bi = oi;
        }
      }
      gap[q] = bi == BIG ? 0 : bi;
    }
  }

  // ---- scalar segmentation logic, identical on every lane ----
  // both-found endpoint rules (gc_hist.pyx:333-351)
  int bmx[MAXP], bmn[MAXP + 1];
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

  int filled[MAXP + 1];
  for (int s = 0; s <= P; ++s) {
    int v = s == 0 ? 0 : BIG;
    if (P > 1 && s >= 1 && s <= n_anchor - 1) v = gap[min(max(s - 1, 0), P - 2)];
    if (s == n_anchor) v = last;
    filled[s] = v;
  }

  // select per case (exclusive)
  const bool raw_max = max_only || none_case;
  const bool raw_min = min_only || none_case;
  int emx[MAXP], emn[MAXP + 1];
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
      int nmn[MAXP + 1];
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
  int lo[MAXP], hi[MAXP];
  bool msk[MAXP];
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
  double mpf[MAXP];
  for (int p = 0; p < P; ++p) {
    double m = -INFINITY;
    if (msk[p]) {
      const int e = min(hi[p], N);
      for (int i = min(max(lo[p], 0), N) + lane; i < e; i += 32) m = fmax(m, xf(i));
      m = warp_max(m);
    }
    mpf[p] = isfinite(m) ? m : 0.0;
  }

  // ---- per-phase sums of exp(x - shift) * [1, key rows] ----
  const double xlast = xf(last);
  const double x0 = xf(0);
  const int K = props ? S + 2 : 1;
  for (int p = 0; p < P; ++p) {
    double acc[4] = {0.0, 0.0, 0.0, 0.0};
    if (msk[p]) {
      const int e = min(hi[p], last);  // bin N-1 is added per phase below
      for (int i = min(max(lo[p], 0), N) + lane; i < e; i += 32) {
        // a bin takes the largest shift of the phases that cover it
        double sh = -INFINITY;
        for (int q = 0; q < P; ++q)
          if (msk[q] && lo[q] <= i && i < hi[q]) sh = fmax(sh, mpf[q]);
        const double w = exp(xf(i) - sh);
        acc[0] += w;
#pragma unroll
        for (int k = 1; k < 4; ++k)
          if (k < K) acc[k] += w * kf(k - 1, i);
      }
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (k < K) acc[k] = warp_sum(acc[k]);
    }
    // bin N-1 with this phase's own shift (the endpoint-overlap rule)
    const bool in_last = msk[p] && lo[p] <= last && last < hi[p];
    const double el = in_last ? exp(xlast - mpf[p]) : 0.0;
    acc[0] += el;
#pragma unroll
    for (int k = 1; k < 4; ++k)
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
