// Fused mu-sweep reweight + segment + per-phase thermo for Hopper (sm_90a).
//
// Replaces the TPU kernel fhmcanalysis_tpu/core/pallas_sweep.py
// (_sweep_ds_pallas -> _kernel -> sweep_block_lanes -> thermo_lanes).  What
// it computes is the float64 semantics of the plain version,
// fhmcanalysis_torch/core/segment.py + pipeline._point_thermo, for one
// state point per warp:
//
//   x = lnpi + a * op                      (a = beta * (mu - mu0), from torch)
//   smooth-window extrema flags, compacted to the first P maxima / P+1 minima
//   endpoint rules, over-smoothing repair, alternation checks, janus collect
//   phase bounds, per-phase max m_p, per-phase sums of exp(x - m_p) * key
//   with bin N-1 added per phase, then fe, <N_i>, <U>, N_tot, x_i, density.
//
// What bounds it on the card: float64 exp (one per bin and point) and the
// serial segmentation logic, not bytes -- lnpi, op and the key rows are a
// few KB shared by every point and stay in L1/L2; a point's output is ~100
// bytes.  The layout keeps every bin-parallel stage on the 32 lanes of a
// warp (stencil, ballot compaction, arg-min gap scans, max and sum
// reductions) and runs the short data-dependent repair logic, over at most
// 2P+1 indices, redundantly on every lane, so no lane ever waits for a
// broadcast.  x is recomputed from global memory where it is needed rather
// than staged, which keeps the kernel free of shared-memory limits in N.
//
// Rounding: x is formed with __dmul_rn/__dadd_rn (and the library is built
// with -fmad=false) so that it is bit-identical to torch's
// `lnpi + a[:, None] * op`: segmentation compares x values exactly.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int MAXP = 8;            // largest max_phases the kernel holds
constexpr int BIG = 2147483647;    // padding sentinel of the index lists
constexpr int WARPS = 8;           // state points per block
constexpr unsigned FULL = 0xffffffffu;

struct Args {
  const double* lnpi;
  const double* op;
  const double* keys;    // [S+1, N]: <N_i> rows, then <U>
  const double* volume;  // scalar
  const double* a;       // [B]
  int B, N, S, P, smooth, props, janus;
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

__device__ __forceinline__ double xval(const Args& g, double a, int i) {
  return __dadd_rn(__ldg(g.lnpi + i), __dmul_rn(a, __ldg(g.op + i)));
}

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

__global__ void __launch_bounds__(32 * WARPS) sweep_thermo_kernel(Args g) {
  __shared__ int s_mx[WARPS][MAXP];
  __shared__ int s_mn[WARPS][MAXP + 1];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long b = (long long)blockIdx.x * WARPS + warp;
  if (b >= g.B) return;  // uniform over the warp

  const int N = g.N, P = g.P, S = g.S, last = N - 1;
  const double a = g.a[b];

  // ---- stencil flags + compaction (segment.stencil_flags) ----
  int n_max0, n_min0;
  compact2(N, lane, [&](int i, bool& is_max, bool& is_min) {
    const double xi = xval(g, a, i);
    bool mx = true, mn = true;
    for (int k = 1; k <= g.smooth && (mx || mn); ++k) {
      const double up = xval(g, a, min(i + k, last));
      const double dn = xval(g, a, max(i - k, 0));
      mx = mx && xi > up && xi > dn;
      mn = mn && xi < up && xi < dn;
    }
    is_max = mx;
    is_min = mn;
  }, s_mx[warp], P, s_mn[warp], P + 1, n_max0, n_min0);

  const bool has_max = n_max0 > 0, has_min = n_min0 > 0;
  const bool none_case = !has_max && !has_min;
  const bool max_only = has_max && !has_min;
  const bool min_only = has_min && !has_max;

  if (none_case) {
    // straight-line fallback (gc_hist.pyx:382-386): every bin equal to the
    // global max / min, first-P truncated with the full count
    double gmx = -INFINITY, gmn = INFINITY;
    for (int i = lane; i < N; i += 32) {
      const double xi = xval(g, a, i);
      gmx = fmax(gmx, xi);
      gmn = fmin(gmn, xi);
    }
    gmx = warp_max(gmx);
    gmn = warp_min(gmn);
    compact2(N, lane, [&](int i, bool& is_max, bool& is_min) {
      const double xi = xval(g, a, i);
      is_max = xi == gmx;
      is_min = xi == gmn;
    }, s_mx[warp], P, s_mn[warp], P + 1, n_max0, n_min0);
  }

  int mx0[MAXP], mn0[MAXP + 1];
  for (int j = 0; j < P; ++j) mx0[j] = s_mx[warp][j];
  for (int j = 0; j <= P; ++j) mn0[j] = s_mn[warp][j];

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
        const double v = sgn * xval(g, a, i);
        if (v < bv) {
          bv = v;
          bi = i;
        }
      }
      for (int o = 16; o; o >>= 1) {
        const double ov = __shfl_xor_sync(FULL, bv, o);
        const int oi = __shfl_xor_sync(FULL, bi, o);
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
  if (g.janus) {
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
      for (int i = min(max(lo[p], 0), N) + lane; i < e; i += 32) m = fmax(m, xval(g, a, i));
      m = warp_max(m);
    }
    mpf[p] = isfinite(m) ? m : 0.0;
  }

  // ---- per-phase sums of exp(x - shift) * [1, key rows] ----
  const double xlast = xval(g, a, last);
  const double x0 = xval(g, a, 0);
  const int K = g.props ? S + 2 : 1;
  const long long ob = b * P;
  for (int p = 0; p < P; ++p) {
    double acc[4] = {0.0, 0.0, 0.0, 0.0};
    if (msk[p]) {
      const int e = min(hi[p], last);  // bin N-1 is added per phase below
      for (int i = min(max(lo[p], 0), N) + lane; i < e; i += 32) {
        // a bin takes the largest shift of the phases that cover it
        double sh = -INFINITY;
        for (int q = 0; q < P; ++q)
          if (msk[q] && lo[q] <= i && i < hi[q]) sh = fmax(sh, mpf[q]);
        const double w = exp(xval(g, a, i) - sh);
        acc[0] += w;
#pragma unroll
        for (int k = 1; k < 4; ++k)
          if (k < K) acc[k] += w * __ldg(g.keys + (size_t)(k - 1) * N + i);
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
      if (k < K) acc[k] += el * __ldg(g.keys + (size_t)(k - 1) * N + last);

    if (lane == 0) {
      const double wsum = acc[0];
      const bool pos = wsum > 0.0;
      const double fe = x0 - mpf[p] - log(pos ? wsum : 1.0);
      g.fe[ob + p] = (msk[p] && pos) ? fe : (msk[p] ? INFINITY : 0.0);
      g.left[ob + p] = lo[p];
      g.right[ob + p] = hi[p];
      g.mask[ob + p] = msk[p] ? 1 : 0;
      if (g.props) {
        const double den = pos ? wsum : 1.0;
        double ni[2];
        double nt = 0.0;
        for (int s = 0; s < S; ++s) {
          ni[s] = acc[1 + s] / den;
          nt = s == 0 ? ni[s] : nt + ni[s];
        }
        const double nsafe = nt != 0.0 ? nt : 1.0;
        for (int s = 0; s < S; ++s) {
          g.n_i[(ob + p) * S + s] = ni[s];
          g.x_i[(ob + p) * S + s] = ni[s] / nsafe;
        }
        g.u[ob + p] = acc[1 + S] / den;
        g.ntot[ob + p] = nt;
        g.density[ob + p] = nt / *g.volume;
      }
    }
  }
  if (lane == 0) {
    g.n_phases[b] = enmax;
    g.valid[b] = valid ? 1 : 0;
  }
}

}  // namespace

extern "C" {

int sweep_thermo_max_phases() { return MAXP; }

const char* sweep_thermo_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// Launches the kernel on `stream` and returns cudaGetLastError() (0 on
// success).  Does not synchronise.  All pointers are device pointers; the
// caller has checked shapes, dtypes and bounds.
int sweep_thermo_launch(int device, void* stream, const double* lnpi, const double* op, const double* keys,
                        const double* volume, const double* a, int B, int N, int S, int P, int smooth, int props,
                        int janus, double* fe, int* left, int* right, unsigned char* mask, int* n_phases,
                        unsigned char* valid, double* n_i, double* x_i, double* ntot, double* u, double* density) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B <= 0) return 0;
  Args g{lnpi, op, keys, volume, a, B, N, S, P, smooth, props, janus, fe, left, right, mask, n_phases, valid,
         n_i, x_i, ntot, u, density};
  const unsigned blocks = (unsigned)((B + WARPS - 1) / WARPS);
  sweep_thermo_kernel<<<blocks, 32 * WARPS, 0, (cudaStream_t)stream>>>(g);
  return (int)cudaGetLastError();
}

}  // extern "C"
