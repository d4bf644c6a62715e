// The 2-D watershed for Hopper (sm_90a): for S surfaces lnpi [S, H, N] and
// their valid mask, the steepest-ascent labels, ranked peaks and flags that
// core/segment2d.py's plain hillclimb_segment_batch computes, bit for bit:
//
//   e = valid ? lnpi : -inf.  Each cell's window argmax over the footprint
//   (2 ry + 1) x (2 rx + 1), separable as the plain code folds it: each row
//   of the window from its centre column outwards (+1, -1, +2, -2, ...),
//   then the rows' winners from the centre row outwards; a candidate is
//   taken where it is larger, or equal above -inf with a lower flat index.
//   is_peak = valid & e == window max; parent = is_peak ? self : argmax.
//   elev_tie: some valid finite cell has an exactly equal valid finite cell
//   in its window.  Peaks with e above the least valid lnPI are ranked by
//   (lnPI descending, flat index ascending); the first P take labels 1..P,
//   n_found counts them all (peak_sat: n_found > P).  Each valid cell takes
//   the label of the end of its chain of parents (0 for a peak past P).
//
// Every output is a compare, a copy or an index, so the bits are the plain
// code's on any device; NaN cells fold as the plain code folds them.
//
// Design.  One block a state.  A state's chain table, one 16-bit parent a
// cell (73.9 KB at 96 x 385), stays in shared memory from the first pass to
// the labels; beside it a bit a cell holds the valid mask (read once) and
// one marks the peak candidates.  The block stages e in bands of rows with
// a halo of ry rows and rx columns of -inf (the plain code's out-of-bounds
// fill, which no fold takes).  As the plain code, it folds each staged
// cell's row first and keeps the winner's column; then each cell of the
// band folds its window's rows' winners, tests the half window {(0, +dj)}
// U {(+di, any dj)} for a value equal to its own (equality is symmetric, so
// every pair of a window is tested once, as the plain tie detector does),
// and adds to the least valid lnPI.  The folds visit +d before -d, so every
// earlier candidate lies left of +d and right of -d (for the rows: above +d,
// below -d): +d is taken where it is larger, -d where it is at least as
// large and above -inf, and no index is compared.  The ranking is P rounds
// of a block argmax over the candidate bits, each after the last winner in
// the ranking order.  The chains are resolved by pointer jumping in place,
// one __syncthreads a round until a round changes nothing: every write
// moves a pointer up its own chain, so the fixed point is the plain code's
// (each cell pointing at its chain's end).  The band is as tall as keeps
// the most blocks an SM (band_rows).

#include <cuda_runtime.h>

#include <cstddef>

namespace ws2d {

constexpr int THREADS = 512;
constexpr int MAX_BLOCKS = 2;  // blocks an SM by the launch bounds (64 registers a thread)
// The footprints the plain function checks for ties in the window (past
// them it scans all cells sorted, a check of another kind).
constexpr long long MAX_FOOTPRINT = 441;
constexpr long long MAX_CELLS = 1LL << 16;  // a state's cells: chain indices are 16-bit
// Shared memory of one Hopper SM, what the runtime keeps of it for each
// resident block, and the most a block may opt into.
constexpr size_t SMEM_SM = 233472;
constexpr size_t SMEM_RESERVED = 1024;
constexpr size_t SMEM_OPTIN = 232448;
constexpr size_t SCRATCH_BYTES = 256;  // the block's reductions

__host__ __device__ inline size_t align16(size_t b) { return (b + 15) / 16 * 16; }
// One staged row: N cells and rx cells of -inf on either side, and each
// cell's winner along the row (a column offset, |offset| <= rx <= 220),
// counted to an even N so that what follows the band stays 4-byte aligned.
__host__ __device__ inline size_t row_bytes(int N, int rx) { return (size_t)(N + 2 * rx) * sizeof(double) + (size_t)(N + 1) / 2 * 2 * sizeof(short); }
__host__ __device__ inline size_t band_bytes(int rows, int N, int ry, int rx) { return (size_t)(rows + 2 * ry) * row_bytes(N, rx); }
__host__ __device__ inline size_t table_bytes(int H, int N) { return align16((size_t)H * N * sizeof(unsigned short)); }
// A bit a cell (the valid mask, the peak candidates).
__host__ __device__ inline size_t bits_bytes(int H, int N) { return align16(((size_t)H * N + 31) / 32 * sizeof(unsigned)); }
__host__ __device__ inline size_t ranked_bytes(int P) { return align16((size_t)P * sizeof(int)); }
// A block's shared bytes but for the band.
__host__ __device__ inline size_t fixed_bytes(int H, int N, int P) { return SCRATCH_BYTES + table_bytes(H, N) + 2 * bits_bytes(H, N) + ranked_bytes(P); }

// Whether the kernel takes surfaces of H x N cells, a footprint of radii
// (ry, rx) and P label slots: a footprint the window tie test covers, chain
// indices of 16 bits, and a block of one band row within the opt-in limit.
__host__ __device__ inline bool fits(int H, int N, int ry, int rx, int P) {
  if (H < 1 || N < 1 || ry < 0 || rx < 0 || P < 1) return false;
  if ((long long)(2 * ry + 1) * (2 * rx + 1) > MAX_FOOTPRINT || (long long)H * N > MAX_CELLS) return false;
  return fixed_bytes(H, N, P) + band_bytes(1, N, ry, rx) <= SMEM_OPTIN;
}

// The blocks an SM holds by shared memory at a band of one row, at most
// MAX_BLOCKS; 0 where the kernel does not take the shape.
__host__ __device__ inline int blocks_per_sm(int H, int N, int ry, int rx, int P) {
  if (!fits(H, N, ry, rx, P)) return 0;
  const size_t b = SMEM_SM / (fixed_bytes(H, N, P) + band_bytes(1, N, ry, rx) + SMEM_RESERVED);
  return b < (size_t)MAX_BLOCKS ? (int)b : MAX_BLOCKS;
}

// The rows of a band: the most that keep blocks_per_sm blocks an SM, at most H.
__host__ __device__ inline int band_rows(int H, int N, int ry, int rx, int P) {
  const int b = blocks_per_sm(H, N, ry, rx, P);
  if (b == 0) return 0;
  size_t block = SMEM_SM / b - SMEM_RESERVED;
  if (block > SMEM_OPTIN) block = SMEM_OPTIN;
  const long long rows = (long long)((block - fixed_bytes(H, N, P)) / row_bytes(N, rx)) - 2 * ry;
  return rows < H ? (int)rows : H;
}

// Dynamic shared bytes of a block (0 where the kernel does not take the shape).
__host__ __device__ inline size_t smem_bytes(int H, int N, int ry, int rx, int P) {
  const int rows = band_rows(H, N, ry, rx, P);
  return rows ? fixed_bytes(H, N, P) + band_bytes(rows, N, ry, rx) : 0;
}

}  // namespace ws2d

#ifdef __CUDACC__

#include <climits>
#include <math_constants.h>

#include "device_guard.cuh"

namespace {

using namespace ws2d;

constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS = THREADS / 32;

struct Args {
  const double* lnpi;          // [S, H, N]
  const unsigned char* valid;  // [H, N], every state's
  int* labels;              // [S, H, N]
  int* n_labels;            // [S]
  double* peak_lnpi;        // [S, P]
  unsigned char* peak_sat;  // [S]
  int* peak_rc;             // [S, P, 2]
  unsigned char* elev_tie;  // [S]
  int H, N, ry, rx, P, band;
};

// Whether (v, i) comes before (w, j) in the ranking order: lnPI descending,
// then flat index ascending.
__device__ __forceinline__ bool before(double v, int i, double w, int j) { return v > w || (v == w && i < j); }

// The block's first (v, i) in the ranking order, on every thread.
__device__ void block_first(double& v, int& i, double* sv, int* si) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const double w = __shfl_xor_sync(FULL, v, o);
    const int j = __shfl_xor_sync(FULL, i, o);
    if (before(w, j, v, i)) v = w, i = j;
  }
  if (lane == 0) sv[warp] = v, si[warp] = i;
  __syncthreads();
  v = sv[0], i = si[0];
  for (int k = 1; k < WARPS; ++k)
    if (before(sv[k], si[k], v, i)) v = sv[k], i = si[k];
  __syncthreads();  // the scratch is free again
}

// The block's least v, on every thread.
__device__ double block_min(double v, double* sv) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const double w = __shfl_xor_sync(FULL, v, o);
    v = w < v ? w : v;
  }
  if (lane == 0) sv[warp] = v;
  __syncthreads();
  v = sv[0];
  for (int k = 1; k < WARPS; ++k) v = sv[k] < v ? sv[k] : v;
  __syncthreads();
  return v;
}

// The block's sum of n, on every thread.
__device__ int block_sum(int n, int* si) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) n += __shfl_xor_sync(FULL, n, o);
  if (lane == 0) si[warp] = n;
  __syncthreads();
  n = 0;
  for (int k = 0; k < WARPS; ++k) n += si[k];
  __syncthreads();
  return n;
}

__global__ void __launch_bounds__(THREADS, MAX_BLOCKS) watershed_kernel(Args g) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int t = threadIdx.x;
  const long long s = blockIdx.x;
  const int H = g.H, N = g.N, ry = g.ry, rx = g.rx, P = g.P, HN = H * N, W = N + 2 * rx;
  const double NEG = -CUDART_INF;
  const double* lnpi = g.lnpi + s * HN;
  const unsigned char* valid = g.valid;

  // shared memory: scratch | band | band's row winners | valid bits | candidate bits | ranked peaks | chain table
  double* sv = (double*)smem;
  int* si = (int*)(smem + WARPS * sizeof(double));
  double* band = (double*)(smem + SCRATCH_BYTES);
  short* win = (short*)(band + (g.band + 2 * ry) * W);
  unsigned* vbits = (unsigned*)(smem + SCRATCH_BYTES + band_bytes(g.band, N, ry, rx));
  unsigned* cand = (unsigned*)((unsigned char*)vbits + bits_bytes(H, N));
  int* ranked = (int*)((unsigned char*)cand + bits_bytes(H, N));
  unsigned short* tab = (unsigned short*)((unsigned char*)ranked + ranked_bytes(P));
  const int words = (HN + 31) >> 5;
  {
    // the valid mask once, a word a warp's ballot, eight words in flight a warp
    const int lane = t & 31, warp = t >> 5;
    for (int w0 = warp * 8; w0 < words; w0 += WARPS * 8) {
      bool v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int i = ((w0 + u) << 5) + lane;
        v[u] = i < HN && valid[i];
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const unsigned b = __ballot_sync(FULL, v[u]);
        if (lane == 0 && w0 + u < words) vbits[w0 + u] = b;
      }
    }
  }
  for (int w = t; w < words; w += THREADS) cand[w] = 0u;
  auto is_valid = [&](int i) { return (vbits[i >> 5] >> (i & 31)) & 1u; };

  // pass 1, band by band: the rows' winners of every staged cell, then each
  // own cell's window argmax, parent, tie test and share of the least valid
  // lnPI
  bool tie = false, nan = false;
  double mn = CUDART_INF;
  const int rows = g.band + 2 * ry;
  for (int r0 = 0; r0 < H; r0 += g.band) {
    __syncthreads();  // the last band's reads are done (before the first: the bits are set)
    {
      int lr = t / W, c = t - lr * W;
      const int dl = THREADS / W, dc = THREADS - dl * W;
#pragma unroll 4
      for (int k = t; k < rows * W; k += THREADS) {
        const int r = r0 - ry + lr, cc = c - rx;
        double x = NEG;
        if (r >= 0 && r < H && cc >= 0 && cc < N && is_valid(r * N + cc)) x = lnpi[r * N + cc];
        band[k] = x;
        lr += dl, c += dc;
        if (c >= W) c -= W, ++lr;
      }
    }
    __syncthreads();
    {
      // each staged cell's winner along its row: the column of the plain
      // code's first fold, as an offset
      int lr = t / N, c = t - lr * N;
      const int dl = THREADS / N, dc = THREADS - dl * N;
      for (int k = t; k < rows * N; k += THREADS) {
        const double* row = band + lr * W + c + rx;
        double v = row[0];
        int j = 0;
#pragma unroll 4
        for (int d = 1; d <= rx; ++d) {
          const double xp = row[d], xm = row[-d];
          if (xp > v) v = xp, j = d;
          if (xm >= v && xm > NEG) v = xm, j = -d;
        }
        win[k] = (short)j;
        lr += dl, c += dc;
        if (c >= N) c -= N, ++lr;
      }
    }
    __syncthreads();
    const int own = (H - r0 < g.band ? H - r0 : g.band) * N;
    int lr = t / N, c = t - lr * N;
    const int dl = THREADS / N, dc = THREADS - dl * N;
    for (int k = t; k < own; k += THREADS) {
      const int self = r0 * N + k, at = (lr + ry) * N + c;
      const double* centre = band + (lr + ry) * W + c + rx;
      const double ec = centre[0];
      int j = win[at];
      double bv = centre[j];
      int bi = self + j;
      // the rows' winners from the centre row outwards (+1, -1, +2, -2, ...)
      for (int di = 1; di <= ry; ++di) {
        j = win[at + di * N];
        double v = centre[di * W + j];
        if (v > bv) bv = v, bi = self + di * N + j;
        j = win[at - di * N];
        v = centre[-di * W + j];
        if (v >= bv && v > NEG) bv = v, bi = self - di * N + j;
      }
      // an equal cell in the half window {(0, +dj)} U {(+di, any dj)}:
      // equality is symmetric, so every pair of the window is tested once
      bool eq = false;
#pragma unroll 4
      for (int d = 1; d <= rx; ++d) eq |= centre[d] == ec;
      for (int di = 1; di <= ry; ++di) {
        const double* row = centre + di * W;
#pragma unroll 4
        for (int d = -rx; d <= rx; ++d) eq |= row[d] == ec;
      }
      lr += dl, c += dc;
      if (c >= N) c -= N, ++lr;
      const bool ok = is_valid(self);
      if (ok) {
        if (ec != ec) nan = true;
        else mn = ec < mn ? ec : mn;
      }
      tie |= eq && isfinite(ec);
      const bool peak = ok && ec == bv;
      tab[self] = (unsigned short)(peak ? self : bi);
      if (peak && ec > NEG) atomicOr(cand + (self >> 5), 1u << (self & 31));
    }
  }
  const bool any_tie = __syncthreads_or(tie);
  const bool any_nan = __syncthreads_or(nan);
  const double min_valid = any_nan ? CUDART_NAN : block_min(mn, sv);

  // the ranking: P rounds of the block's first candidate after the last winner
  int n_found = 0, n_ranked = 0;
  double pv = CUDART_INF;
  int pi = -1;
  for (int k = 0; k < P; ++k) {
    double bv = NEG;
    int bi = INT_MAX, cnt = 0;
    for (int w = t; w < words; w += THREADS) {
      unsigned bits = cand[w];
      while (bits) {
        const int i = (w << 5) + __ffs(bits) - 1;
        bits &= bits - 1;
        const double x = lnpi[i];
        if (!(x > min_valid)) continue;
        ++cnt;
        if (before(pv, pi, x, i) && before(x, i, bv, bi)) bv = x, bi = i;
      }
    }
    if (k == 0) n_found = block_sum(cnt, si);
    block_first(bv, bi, sv, si);
    if (bi == INT_MAX) break;
    if (t == 0) ranked[k] = bi;
    pv = bv, pi = bi, n_ranked = k + 1;
  }

  // the chains: pointer jumping in place until a round changes nothing;
  // chains of at most MAX_CELLS cells end within 16 rounds, so the 17th
  // finds no change and the bound never cuts a chain short
  volatile unsigned short* vt = tab;
  for (int round = 0; round < 17; ++round) {
    int changed = 0;
#pragma unroll 4
    for (int i = t; i < HN; i += THREADS) {
      const unsigned p = vt[i], pp = vt[p];
      if (pp != p) vt[i] = (unsigned short)pp, changed = 1;
    }
    if (!__syncthreads_or(changed)) break;
  }

  int* lab = g.labels + s * HN;
  for (int i = t; i < HN; i += THREADS) {
    int l = 0;
    if (is_valid(i)) {
      const int root = tab[i];
      for (int k = 0; k < n_ranked; ++k)
        if (ranked[k] == root) {
          l = k + 1;
          break;
        }
    }
    lab[i] = l;
  }
  for (int k = t; k < P; k += THREADS) {
    const bool live = k < n_ranked;
    const int i = live ? ranked[k] : 0;
    g.peak_lnpi[s * P + k] = live ? lnpi[i] : 0.0;
    g.peak_rc[(s * P + k) * 2] = live ? i / N : -1;
    g.peak_rc[(s * P + k) * 2 + 1] = live ? i % N : -1;
  }
  if (t == 0) {
    g.n_labels[s] = n_found < P ? n_found : P;
    g.peak_sat[s] = n_found > P;
    g.elev_tie[s] = any_tie;
  }
}

}  // namespace

extern "C" {

const char* watershed2d_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// The library's rule, as the launch applies it (footprint radii ry, rx).
int watershed2d_fits(int H, int N, int ry, int rx, int P) { return ws2d::fits(H, N, ry, rx, P); }

// Launches the watershed of S states of H x N cells on `stream` of
// `device`, one block a state, and returns cudaGetLastError() (0 on
// success; cudaErrorInvalidValue where watershed2d_fits refuses the shape),
// leaving the thread's current device as it found it.  Does not
// synchronise.  All pointers are device pointers; the caller has checked
// shapes and dtypes (lnpi f64 [S, H, N]; valid bool [H, N]; labels int32
// [S, H, N]; n_labels int32 [S]; peak_lnpi f64 [S, P]; peak_sat, elev_tie
// bool [S]; peak_rc int32 [S, P, 2]; all contiguous).
int watershed2d_launch(int device, void* stream, const double* lnpi, const unsigned char* valid, long long S, int H, int N,
                       int ry, int rx, int P, int* labels, int* n_labels, double* peak_lnpi, unsigned char* peak_sat, int* peak_rc,
                       unsigned char* elev_tie) {
  const fhmc::DeviceGuard on(device);
  if (on.status() != cudaSuccess) return (int)on.status();
  if (S <= 0) return 0;
  if (!ws2d::fits(H, N, ry, rx, P)) return (int)cudaErrorInvalidValue;
  const size_t dyn = ws2d::smem_bytes(H, N, ry, rx, P);
  cudaError_t e = cudaFuncSetAttribute(watershed_kernel, cudaFuncAttributePreferredSharedMemoryCarveout, cudaSharedmemCarveoutMaxShared);
  if (e == cudaSuccess) e = cudaFuncSetAttribute(watershed_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
  if (e != cudaSuccess) return (int)e;
  const Args g{lnpi, valid, labels, n_labels, peak_lnpi, peak_sat, peak_rc, elev_tie, H, N, ry, rx, P, ws2d::band_rows(H, N, ry, rx, P)};
  watershed_kernel<<<(unsigned)S, THREADS, dyn, (cudaStream_t)stream>>>(g);
  return (int)cudaGetLastError();
}

}  // extern "C"

#endif  // __CUDACC__
