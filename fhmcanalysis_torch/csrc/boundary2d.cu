// The 2-D boundary integrals for Hopper (sm_90a): for S surfaces lnpi
// [S, H, N] and their watershed labels lab [S, H, N], the transition-state
// integrals min_df and max_val [S, L+1, L+1] between every pair of labels
// (L = max_labels), as core/segment2d.py's one-hot engine computes them
// (pore_hist._segment, pore_hist.pyx:425-445):
//
//   A cell p counts when lab[p] = a > 0 and p is an inner 4-connectivity
//   boundary pixel (edge-padded: some in-bounds 4-neighbour differs).  Each
//   of its 8 in-bounds neighbours q with lab[q] = b > 0, b != a, adds one
//   contribution (lnpi[p], lnpi[q]) to the unordered pair (min(a,b), max(a,b)).
//   Pass 1: M = the max over the pair's contributions of max(lnpi[p], lnpi[q]),
//   Mf = M where finite, else 0.  Pass 2: E = 0.5 (exp(lnpi[p] - Mf) +
//   exp(lnpi[q] - Mf)) per contribution, min_df = Mf + log(sum E) and max_val
//   = Mf + log(max E), -DBL_MAX where the sum or the max is 0 (no shared
//   boundary), on the diagonal and in row and column 0; the table is
//   written symmetric.
//
// Each step rounds as the plain one-hot does (the library is built with
// -fmad=false, and exp and log are the card's, as torch's), and M and max E
// are maxima, exact in any order: max_val equals the plain one-hot on the
// card bit for bit.  min_df differs only by the order of the sum, which is
// fixed here, so the same inputs give the same bits on every run.
//
// Design.  A state's data (444 KB at 96 x 385) does not fit in shared
// memory, but its boundary is a line: ~1,000 contributions against 37,000
// cells (a pore96 state).  So one block a state streams its cells once, in
// tiles of THREADS x CPT cells with coalesced loads of the labels, reading
// lnpi only at contributions, and compacts each tile's contributions
// (pair, lnpi[p], lnpi[q]) into a list in shared memory in a fixed order (a
// block-wide prefix sum of the threads' counts, no atomic counter).  The
// pair maxima of pass 1 are atomic maxima on the values' ordered bits, in
// a table in shared memory where it fits (table_fits) and in device memory
// where it does not.  Pass 2 runs over the list alone: a warp a pair, each
// lane summing its stride of the list, then a fixed shuffle tree.  Where
// the list overflows, it keeps the tiles whose contributions fit whole,
// and pass 2 reads the state's cells from the first tile that did not fit
// again from device memory, a tile of THREADS cells at a time (at most CAP
// contributions), in the same order: a joint96 state (~2,200
// contributions) reads a few tiles twice, a random label field (~5
// contributions a cell) all of them.  One block a state at every S, S = 1
// (the pore_hist class) too: 0.11 ms there on an H100, against ~19 ms for
// the class's phase_average.

#include <cuda_runtime.h>

#include <cstddef>

namespace b2d {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int CPT = 4;               // cells a thread in a tile of pass 1
constexpr int TILE = THREADS * CPT;  // cells of a tile of pass 1
// The list: entries a block keeps in shared memory.  A tile of pass 2's
// re-read (THREADS cells, 8 neighbours each) fills it at most.
constexpr int CAP = 8 * THREADS;
constexpr size_t ENTRY_BYTES = sizeof(int) + 2 * sizeof(double);  // pair, lnpi[p], lnpi[q]
constexpr size_t LIST_BYTES = CAP * ENTRY_BYTES;
constexpr size_t PAIR_BYTES = 3 * sizeof(double);  // M (ordered bits), sum E, max E
// Shared memory of one Hopper SM, and what the runtime keeps of it for each
// resident block (as mb_sweep_thermo.cu's rule counts them).
constexpr size_t SMEM_SM = 233472;
constexpr size_t SMEM_RESERVED = 1024;
// The blocks an SM holds by the list alone; the pair table goes into shared
// memory only where it leaves as many.
constexpr int LIST_BLOCKS = (int)(SMEM_SM / (LIST_BYTES + SMEM_RESERVED));
static_assert(SMEM_SM / LIST_BLOCKS - SMEM_RESERVED <= 48 * 1024, "a block's shared bytes stay within what it gets without opting in");

__host__ __device__ inline long long n_pairs(int L) { return (long long)L * (L - 1) / 2; }
__host__ __device__ inline size_t table_bytes(int L) { return (size_t)n_pairs(L) * PAIR_BYTES; }

// Whether a block keeps the pair table of L labels in shared memory.
__host__ __device__ inline bool table_fits(int L) { return (size_t)LIST_BLOCKS * (LIST_BYTES + table_bytes(L) + SMEM_RESERVED) <= SMEM_SM; }

// Dynamic shared bytes of a block.
__host__ __device__ inline size_t smem_bytes(int L) { return LIST_BYTES + (table_fits(L) ? table_bytes(L) : 0); }

// The launch's scratch in device memory: the states' pair tables
// [S][3][n_pairs] where they do not fit in shared memory, else none.
__host__ __device__ inline size_t scratch_bytes(long long S, int L) { return table_fits(L) ? 0 : (size_t)S * table_bytes(L); }

}  // namespace b2d

#ifdef __CUDACC__

#include "device_guard.cuh"

namespace {

using namespace b2d;

constexpr unsigned FULL = 0xffffffffu;
constexpr double BIGNEG = -1.7976931348623157e308;  // -DBL_MAX, the reference's fill (pore_hist.pyx:40)
// Neighbour d's row and column offsets, in the plain engine's order
// (segment2d._NEBR8): (1, 1), (1, 0), (1, -1), (0, -1), (-1, -1), (-1, 0),
// (-1, 1), (0, 1).
__device__ __forceinline__ int nebr_di(int d) { return d < 3 ? 1 : d == 3 || d == 7 ? 0 : -1; }
__device__ __forceinline__ int nebr_dj(int d) { return d == 0 || d >= 6 ? 1 : d == 1 || d == 5 ? 0 : -1; }

struct Args {
  const double* lnpi;  // [S, H, N]
  const int* lab;      // [S, H, N]
  double* min_df;      // [S, L+1, L+1]
  double* max_val;
  double* tables;  // [S][3][n_pairs] where the pair table does not fit in shared memory, else null
  int H, N, L;
};

// A double's bits, mapped so that unsigned order is the doubles' order; 0
// (no double maps there but one NaN) marks a pair with no contribution.
__device__ __forceinline__ unsigned long long ordered(double v) {
  const unsigned long long u = (unsigned long long)__double_as_longlong(v);
  return (u >> 63) ? ~u : u | 0x8000000000000000ull;
}
__device__ __forceinline__ double unordered(unsigned long long o) {
  return __longlong_as_double((long long)((o >> 63) ? o & 0x7fffffffffffffffull : ~o));
}

// The pair index of labels 1 <= a < b <= L.
__device__ __forceinline__ int pair_index(int a, int b) { return (b - 1) * (b - 2) / 2 + (a - 1); }

// A state's pair table: M, the sums of E and the maxima of E, by pair.
struct Table {
  unsigned long long* m;
  double* sum;
  double* mx;
  bool global;
  __device__ unsigned long long ld_m(int k) const { return global ? __ldcg(m + k) : m[k]; }
  __device__ double ld_sum(int k) const { return global ? __ldcg(sum + k) : sum[k]; }
  __device__ double ld_mx(int k) const { return global ? __ldcg(mx + k) : mx[k]; }
};

// The 8-bit mask of cell (r, c)'s contributing directions (bit d: NEBR
// direction d); a = lab at the cell, 0 < a <= L.
__device__ __forceinline__ unsigned contributions(const int* __restrict__ lab, int H, int N, int L, int r, int c, int a) {
  const int* p = lab + (long long)r * N + c;
  const int u = r > 0 ? p[-N] : a, d = r + 1 < H ? p[N] : a;
  const int l = c > 0 ? p[-1] : a, rt = c + 1 < N ? p[1] : a;
  if (u == a && d == a && l == a && rt == a) return 0;  // no boundary pixel
  unsigned m = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int rr = r + nebr_di(k), cc = c + nebr_dj(k);
    if (rr < 0 || rr >= H || cc < 0 || cc >= N) continue;
    const int b = p[nebr_di(k) * N + nebr_dj(k)];
    if (b > 0 && b != a && b <= L) m |= 1u << k;
  }
  return m;
}

__device__ __forceinline__ int warp_inclusive(int v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int n = __shfl_up_sync(FULL, v, o);
    if (lane >= o) v += n;
  }
  return v;
}

// The shared list, structure of arrays.
struct List {
  int* k;
  double* lp;
  double* lq;
};

// One tile of C cells a thread from cell c0 (state-local) up to c1: each
// thread's contributions go to the list from position `at` on, in thread
// order, then cell, then direction; with FIRST (pass 1) each also raises
// its pair's M, and entries from CAP on are dropped.  Returns the tile's
// count, the same on every thread.
template <int C, bool FIRST>
__device__ int tile(const Args& g, const double* __restrict__ lnpi, const int* __restrict__ lab, int c0, int c1, List list, int at, Table tab,
                    int* s_warp) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  int a[C], r[C], col[C];
  unsigned m[C];
  int cnt = 0;
#pragma unroll
  for (int j = 0; j < C; ++j) {
    const int c = c0 + j * THREADS + t;
    a[j] = c < c1 ? lab[c] : 0;
    r[j] = c / g.N;
    col[j] = c - r[j] * g.N;
  }
#pragma unroll
  for (int j = 0; j < C; ++j) {
    m[j] = a[j] > 0 && a[j] <= g.L ? contributions(lab, g.H, g.N, g.L, r[j], col[j], a[j]) : 0u;
    cnt += __popc(m[j]);
  }
  if (!__syncthreads_or(cnt)) return 0;  // also: every thread is done with s_warp's last values
  const int incl = warp_inclusive(cnt, lane);
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int v = lane < WARPS ? s_warp[lane] : 0;
    v = warp_inclusive(v, lane);
    if (lane < WARPS) s_warp[lane] = v;
  }
  __syncthreads();
  int pos = at + (warp ? s_warp[warp - 1] : 0) + incl - cnt;
  const int total = s_warp[WARPS - 1];
#pragma unroll
  for (int j = 0; j < C; ++j) {
    unsigned mj = m[j];
    if (!mj) continue;
    const int p = r[j] * g.N + col[j];
    const double lp = lnpi[p];
    while (mj) {
      const int d = __ffs(mj) - 1;
      mj &= mj - 1;
      const int q = p + nebr_di(d) * g.N + nebr_dj(d);
      const int b = lab[q];
      const double lq = lnpi[q];
      const int k = a[j] < b ? pair_index(a[j], b) : pair_index(b, a[j]);
      if (FIRST) atomicMax(tab.m + k, ordered(lp > lq || lp != lp ? lp : lq));  // torch.maximum, NaN included
      if (!FIRST || pos < CAP) {
        list.k[pos] = k;
        list.lp[pos] = lp;
        list.lq[pos] = lq;
      }
      ++pos;
    }
  }
  return total;
}

// Pass 2 over n entries of the shared list: a warp a pair, adding the
// chunk's sum of E to the pair's and raising its max E.
__device__ void accumulate(List list, int n, Table tab, int np) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int k = warp; k < np; k += WARPS) {
    const unsigned long long mo = tab.ld_m(k);
    if (mo == 0) continue;  // no contribution
    const double M = unordered(mo);
    const double Mf = isfinite(M) ? M : 0.0;
    double s = 0.0, x = 0.0;
    for (int i = lane; i < n; i += 32) {
      if (list.k[i] != k) continue;
      const double e = 0.5 * (exp(list.lp[i] - Mf) + exp(list.lq[i] - Mf));
      s += e;
      x = e > x ? e : x;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      s += __shfl_down_sync(FULL, s, o);
      const double y = __shfl_down_sync(FULL, x, o);
      x = y > x ? y : x;
    }
    if (lane == 0) {
      tab.sum[k] = tab.ld_sum(k) + s;
      const double x0 = tab.ld_mx(k);
      tab.mx[k] = x > x0 ? x : x0;
    }
  }
}

// Pass 2 by re-reading cells [c0, c1) of a state, a tile of THREADS cells at a time.
__device__ void reread(const Args& g, const double* lnpi, const int* lab, int c0, int c1, List list, Table tab, int np, int* s_warp) {
  for (int c = c0; c < c1; c += THREADS) {
    const int n = tile<1, false>(g, lnpi, lab, c, c1, list, 0, tab, s_warp);
    __syncthreads();
    accumulate(list, n, tab, np);
    __syncthreads();
  }
}

__global__ void __launch_bounds__(THREADS) boundary_pairs_kernel(Args g) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_warp[WARPS];
  const int t = threadIdx.x;
  const long long s = blockIdx.x;
  const int HN = g.H * g.N;
  const double* lnpi = g.lnpi + s * (long long)HN;
  const int* lab = g.lab + s * (long long)HN;
  const int np = (int)n_pairs(g.L);
  List list{(int*)smem, (double*)(smem + CAP * sizeof(int)), (double*)(smem + CAP * sizeof(int)) + CAP};
  Table tab;
  tab.global = g.tables != nullptr;
  double* base = tab.global ? g.tables + s * 3 * (long long)np : (double*)(smem + LIST_BYTES);
  tab.m = (unsigned long long*)base;
  tab.sum = base + np;
  tab.mx = base + 2 * np;
  for (int k = t; k < np; k += THREADS) {
    tab.m[k] = 0;
    tab.sum[k] = 0.0;
    tab.mx[k] = 0.0;
  }
  __syncthreads();

  // pass 1: the state's cells once; the list keeps the tiles before c_over
  // (n entries), whose contributions fit whole, and no entry from c_over on
  int n = 0, c_over = HN;
  for (int c = 0; c < HN; c += TILE) {
    const int total = tile<CPT, true>(g, lnpi, lab, c, HN, list, c_over == HN ? n : CAP, tab, s_warp);
    if (c_over == HN && n + total > CAP) c_over = c;
    if (c_over == HN) n += total;
  }
  __syncthreads();

  // pass 2: the list, then the cells from c_over read again
  accumulate(list, n, tab, np);
  __syncthreads();
  reread(g, lnpi, lab, c_over, HN, list, tab, np, s_warp);
  __syncthreads();

  // the outputs: the pair's entries both ways, -DBL_MAX elsewhere
  const int L1 = g.L + 1;
  double* od = g.min_df + s * L1 * L1;
  double* ox = g.max_val + s * L1 * L1;
  for (int i = t; i < L1 * L1; i += THREADS) {
    const int a = i / L1, c = i - a * L1;
    double df = BIGNEG, mv = BIGNEG;
    if (a > 0 && c > 0 && a != c) {
      const int k = a < c ? pair_index(a, c) : pair_index(c, a);
      const unsigned long long mo = tab.ld_m(k);
      if (mo != 0) {
        const double M = unordered(mo);
        const double Mf = isfinite(M) ? M : 0.0;
        const double sm = tab.ld_sum(k), x = tab.ld_mx(k);
        if (sm > 0.0) df = Mf + log(sm);
        if (x > 0.0) mv = Mf + log(x);
      }
    }
    od[i] = df;
    ox[i] = mv;
  }
}

}  // namespace

extern "C" {

const char* boundary2d_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// The library's rules, as the launch applies them.
int boundary2d_list_cap() { return b2d::CAP; }
int boundary2d_table_fits(int max_labels) { return b2d::table_fits(max_labels); }
long long boundary2d_scratch_bytes(long long S, int max_labels) { return (long long)b2d::scratch_bytes(S, max_labels); }

// Launches the boundary integrals of S states of H x N cells on `stream` of
// `device`, one block a state, and returns cudaGetLastError() (0 on
// success; cudaErrorInvalidValue for scratch smaller than
// boundary2d_scratch_bytes), leaving the thread's current device as it
// found it.  Does not synchronise.  All pointers are device pointers; the
// caller has checked shapes and dtypes (lnpi f64, lab int32, both [S, H, N]
// contiguous; min_df, max_val f64 [S, max_labels + 1, max_labels + 1]).
int boundary2d_launch(int device, void* stream, const double* lnpi, const int* lab, long long S, int H, int N, int max_labels, double* min_df,
                      double* max_val, void* scratch, long long scratch_bytes) {
  const fhmc::DeviceGuard on(device);
  if (on.status() != cudaSuccess) return (int)on.status();
  if (S <= 0) return 0;
  const size_t need = b2d::scratch_bytes(S, max_labels);
  if (scratch_bytes < (long long)need || (need > 0 && scratch == nullptr)) return (int)cudaErrorInvalidValue;
  const Args g{lnpi, lab, min_df, max_val, need > 0 ? (double*)scratch : nullptr, H, N, max_labels};
  boundary_pairs_kernel<<<(unsigned)S, THREADS, smem_bytes(max_labels), (cudaStream_t)stream>>>(g);
  return (int)cudaGetLastError();
}

}  // extern "C"

#endif  // __CUDACC__
