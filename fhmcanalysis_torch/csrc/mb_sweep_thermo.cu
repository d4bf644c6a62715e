// Fused (mu_1, beta, dMu) extrapolating sweep for Hopper (sm_90a): kernel K2.
//
// Replaces the TPU kernel fhmcanalysis_tpu/core/pallas_mb.py
// (_mb_ds_pallas -> _kernel -> mb_block_lanes -> extrap_source_lanes ->
// thermo_lanes).  What it computes is the float64 semantics of the plain
// version, fhmcanalysis_torch/core/pipeline.py mu_beta_sweep_body, for one
// point (mu_m, beta_t, dMu_t) per group of G lanes:
//
//   x'(i)  = lnpi + a_m op + dB (r1 + mu_m op) + dd m1
//            + [order 2] 0.5 ((dB^2 h00 + 2 dB dd h01) + dd^2 h11)
//   key'_k = key_k + dB sgB_k + dd sgM_k
//            + [order 2, not first_order_mom] 0.5 ((dB^2 sgB2_k + 2 dB dd sgX_k) + dd^2 sgM2_k)
//
// (the dd terms at nspec 2 only; the former lives in extrap_rows.cuh,
// shared with K3), then the tail it shares with K1 and K3
// (thermo_tail.cuh).  The TPU kernel also formed the grand-canonical
// averages <N_i>, <U> (and at order 2 seven more sums and the gc_dX_dB
// algebra) per point with a second exp pass; they shift lnPI' by a
// constant over the bins that the tail cancels, so this kernel has no
// second exp pass and no reduction beyond the tail's own.
//
// Two modes, a template argument: the product of M mu values and A
// targets, point b = m * A + t; and the paired mode (tix given), M points,
// point b at (mu_b, target tix[b]), which the coexistence solver launches
// with one mu per target (core/solve.py; its plain version is
// pipeline._mb_chunk with tix).  Only the choice of (m, t) differs, so a
// paired point equals the product's point (m, tix[m]) bit for bit, and the
// product mode compiles as it did before the paired one existed.  A paired
// point with tix outside [0, A) is marked invalid rather than read.
//
// What bounds it on the card: the same as K1 -- float64 exp (one per bin
// and point) and the serial segmentation logic -- and the f64 operations
// that form x' and key' from the rows.  The rows (up to 7 for x', up to 18
// for the key rows) are a few KB shared by every point; a point's output
// is ~300 bytes at P=4 with props, which at the main path's 4.2M points is
// the larger floor (PERF.md).  The layout is K1's: a template on G, the
// lanes per point, with G picked by the same rule
// (cuda_sweep.lanes_per_point); G = 32 reads the rows through the
// read-only cache, G = 1 stages them in shared memory where they fit
// (about 6 KB at N = 31), which took 6-14% off mb31 (PERF.md).
//
// The x' area.  The tail reads x' about 5 times a bin: 3N reads in the
// stencil, about N in the per-phase maxima and N in the sums, and the two
// ends, ~156 reads a point at N = 31, of which 31 are distinct; each read
// formed from the rows costs 15 f64 operations and 7 row loads at order 2
// and nspec 2 (the library is built with -fmad=false, so each is an
// instruction of its own).  So where cuda_mb.xarea_fits holds, at G = 1
// where a block's area fits beside its index slots, its row tile and the
// most rows it stages with the eight blocks an SM its build is made for (N
// <= 33 in the build of 8 slots, N <= 36 in that of 64), each lane first
// forms its point's x' once a bin into an area of dynamic shared memory (a
// fourth template argument, XA), with the same expression in the same
// rounding, and the tail reads it there.  The area's build runs blocks of
// 64 points (XA_THREADS), and its area is laid out [bin][point]: bin i of
// the block's point pt at i * 64 + pt, a row pitch of 512 bytes, so the
// bank of a slot depends on pt alone and a warp's reads are free of
// conflicts whatever bins its lanes are at; a lane reads only its own
// column, so no barrier follows the forming pass.  The area is 15.5 KB a
// block at N = 31, 27 KB with the slots and rows; it costs occupancy, 16
// warps an SM where the re-forming build holds 24, and took mb31_o2 from
// 3.8-3.9 to 3.4-3.6 ms; mb31_o1, with 7 operations fewer a read, did not
// move (PERF.md).  Elsewhere (G =
// 32, and N past the limit: multi573, the solver's paired steps, the
// example workflows) x' is formed again at every read, which keeps the
// kernel free of shared-memory limits in N.  key' is read once per covered
// bin and is formed on read in every build.  The outputs are the same bits
// on either route.
//
// Capacities: a third template argument, CAP, is the phase slots a point
// holds (8 or 64; thermo_tail.cuh), so that K2 answers every max_phases up
// to 64 as the JAX kernel does; cuda_sweep.capacity picks the smallest
// build that holds the run, the same for K1, and CAP 8 is the kernel as it
// was before the wide build.  The build of 64 slots runs the tail's wide
// body and writes its rows as K1's does (a 1 KB tile a warp at G = 1).
// nspec stays 1-2 (the moment algebra's limit, as in the JAX package), so
// every build keeps 4 per-phase sums.
//
// Rounding: x' is formed with __dmul_rn/__dadd_rn in exactly the plain
// version's association (and the library is built with -fmad=false), so
// segmentation agrees bit for bit.  At identity targets every added term
// is an exact zero and the kernel returns K1's output bit for bit.

#include <string.h>

#include "device_guard.cuh"
#include "extrap_rows.cuh"
#include "mb_rows.cuh"
#include "thermo_tail.cuh"

namespace {

using tail::THREADS;

struct Args {
  const double* lnpi;    // [N]
  const double* op;      // [N]
  const double* xrows;   // [R, N]: r1, m1 (S=2), then order 2: h00, h01, h11 (S=2)
  const double* krows;   // [G, S+1, N]: key, sgB, sgM (S=2), then sgB2, sgX, sgM2 (S=2)
  const double* volume;  // scalar
  const double* mu;      // [M]
  const double* a;       // [M]
  const double* tg;      // [A, T]: dB, dd (S=2), then order 2: dB^2, 2 dB dd, dd^2 (S=2)
  const int* tix;        // [M]: each point's target (paired mode), or null (product mode)
  int M, A, N, S, P, smooth, order, props, khess, janus;
  tail::Out out;
};

// Rows of xrows and, with props, of krows (cuda_mb.n_xrows, n_groups).
__host__ __device__ __forceinline__ int x_rows(const Args& g) { return tail::n_targets(g.S, g.order); }
__host__ __device__ __forceinline__ int k_rows(const Args& g) {
  return g.props ? (1 + g.S + (g.khess ? (g.S == 1 ? 1 : 3) : 0)) * (g.S + 1) : 0;
}

// Bytes of the rows a block may stage in shared memory: lnpi, op, xrows, krows.
__host__ __device__ __forceinline__ size_t row_bytes(const Args& g) {
  return (size_t)(2 + x_rows(g) + k_rows(g)) * g.N * sizeof(double);
}

// Points of a launch: M x A in the product mode, M in the paired mode.
template <bool PAIRED>
__host__ __device__ __forceinline__ long long n_points(const Args& g) {
  return PAIRED ? (long long)g.M : (long long)g.M * g.A;
}

// A paired point whose target lies outside [0, A): written as an invalid
// point with no phase and NaN floats, instead of reading tg out of bounds.
__device__ __forceinline__ void out_of_range_point(const Args& g, long long b) {
  const double nan = __longlong_as_double(0x7ff8000000000000LL);
  const tail::Out& o = g.out;
  for (int p = 0; p < g.P; ++p) {
    const long long ob = b * g.P + p;
    o.fe[ob] = nan;
    o.left[ob] = o.right[ob] = -1;
    o.mask[ob] = 0;
    if (g.props) {
      for (int s = 0; s < g.S; ++s) o.n_i[ob * g.S + s] = o.x_i[ob * g.S + s] = nan;
      o.ntot[ob] = o.u[ob] = o.density[ob] = nan;
    }
  }
  o.n_phases[b] = 0;
  o.valid[b] = 0;
}

// The x' area (XA): shared memory of one Hopper SM and what the runtime
// keeps of it for each resident block; the area's build runs blocks of 64
// points, 8 of them an SM (16 warps), and stages every row beside the
// area, at most 25 of them (lnpi, op, 5 x-rows, 18 key rows: nspec 2,
// order 2, props, the order-2 key rows).  Of the block shapes timed on
// mb31_o2 (PERF.md), 256 points and 2 blocks an SM, 128 and 4, 96 and 6,
// 64 and 8, with every row or only the key rows staged, this one was the
// fastest: small blocks free their share of the SM as soon as their own
// warps end, and rows read from global memory in the forming pass cost
// more than the shared memory they would free.
constexpr size_t SMEM_SM = 233472;
constexpr size_t SMEM_RESERVED = 1024;
constexpr int XA_THREADS = 64;
constexpr int XA_MIN_BLOCKS = 8;
constexpr int XA_ROWS = 25;

template <bool XA>
__host__ __device__ constexpr int block_threads() { return XA ? XA_THREADS : THREADS; }

// At least 3 blocks per SM (at most 85 registers) at both G without the
// area: at G = 32 without the bound ptxas picks fewer registers and
// spills; at G = 1 it takes 93 registers (2 blocks per SM) and runs 13-15%
// slower at mb31_o1, while 4 blocks (64 registers) spill (PERF.md).  The
// area's build asks for the XA_MIN_BLOCKS its shared memory allows.
template <bool XA>
__host__ __device__ constexpr int min_blocks() { return XA ? XA_MIN_BLOCKS : 3; }

// Static shared bytes of a block of the area's build (G = 1): the index
// slots and the wide build's row tile.
template <int CAP>
__host__ __device__ constexpr size_t xa_static_bytes() {
  constexpr int T = block_threads<true>();
  return (tail::slots_shared(1, CAP) ? (size_t)(2 * CAP + 1) * sizeof(int) * T : 0) + (tail::row_tile_bytes(1, CAP) ? T / 32 * tail::ROW_TILE : 0);
}

// Bytes of a block's x' area: N doubles for each of its points.
template <int G>
__host__ __device__ __forceinline__ size_t xarea_bytes(int N) {
  return (size_t)(block_threads<true>() / G) * N * sizeof(double);
}

// Whether a block at G lanes a point takes the x' area: at G = 1, where the
// area, the index slots, the row tile and the most rows a block stages
// leave the XA_MIN_BLOCKS blocks an SM the build is made for (past that, at
// N = 40-47, the area ran no faster than forming x' on read: PERF.md);
// cuda_mb.xarea_fits reports the same.
template <int CAP>
__host__ __device__ __forceinline__ bool xarea_fits(int G, int N) {
  if (G != 1) return false;
  const size_t rows = (size_t)XA_ROWS * N * sizeof(double);
  const size_t block = xarea_bytes<1>(N) + rows + xa_static_bytes<CAP>() + SMEM_RESERVED;
  return XA_MIN_BLOCKS * block <= SMEM_SM;
}

// Whether a block stages the rows in shared memory: with the area always
// (its rule counts them); without it, where they fit in 48 KB.
template <int G, int CAP, bool XA>
__host__ __device__ __forceinline__ bool stages(const Args& g) {
  return XA || tail::stages_rows<G, CAP>(row_bytes(g), tail::row_tile_bytes(G, CAP));
}

// The block's copy of n doubles from global into shared memory, T threads a block.
template <int T>
__device__ __forceinline__ void stage(double* dst, const double* src, int n) {
  for (int k = threadIdx.x; k < n; k += T) dst[k] = src[k];
}

template <int G, bool PAIRED, int CAP, bool XA>
__global__ void __launch_bounds__(block_threads<XA>(), min_blocks<XA>()) mb_sweep_thermo_kernel(Args g) {
  static_assert(!XA || G == 1, "the x' area is the layout of one lane a point");
  constexpr int PTS = block_threads<XA>() / G;  // points per block
  constexpr bool NC = G == 32;      // rows read through the read-only cache
  constexpr bool SH = tail::slots_shared(G, CAP);
  __shared__ int s_mx[SH ? CAP * PTS : 1];
  __shared__ int s_mn[SH ? (CAP + 1) * PTS : 1];
  constexpr int TILE = tail::row_tile_bytes(G, CAP) ? PTS / 32 * tail::ROW_TILE : 0;
  __shared__ __align__(16) unsigned char s_tile[TILE ? TILE : 1];  // the wide build's row tile (G = 1)
  extern __shared__ double s_dyn[];  // the staged rows (G < 32), then the x' area (XA)
  const int pt = threadIdx.x / G;
  const long long b = (long long)blockIdx.x * PTS + pt;
  const double *lnpi = g.lnpi, *op = g.op, *xrows = g.xrows, *krows = g.krows;
  double* xa = s_dyn + pt;  // XA: bin i of the block's point pt at i * PTS + pt
  if constexpr (G < 32) {
    // the rows, staged in shared memory by the whole block
    if (stages<G, CAP, XA>(g)) {
      const int N = g.N, XN = x_rows(g) * N;
      stage<PTS * G>(s_dyn, lnpi, N);
      stage<PTS * G>(s_dyn + N, op, N);
      stage<PTS * G>(s_dyn + 2 * N, xrows, XN);
      stage<PTS * G>(s_dyn + 2 * N + XN, krows, k_rows(g) * N);
      __syncthreads();
      lnpi = s_dyn;
      op = s_dyn + N;
      xrows = s_dyn + 2 * N;
      krows = s_dyn + 2 * N + XN;
      xa += 2 * N + XN + k_rows(g) * N;
    }
  }
  const bool in = b < n_points<PAIRED>(g);
  // the wrapper checks tix's range once per tensor version; this guard
  // holds whatever wrote tix since (every lane of the group returns)
  const bool tix_ok = !PAIRED || !in || (unsigned)g.tix[b] < (unsigned)g.A;
  // G = 1: the warp's lanes that hold an in-range point (the wide build's rows)
  const unsigned live = TILE ? __ballot_sync(tail::FULL, in && tix_ok) : tail::FULL;
  if (!in) return;  // G = 32: the warp; else the group, whose collectives name only its lanes
  if (!tix_ok) {
    if (threadIdx.x % G == 0) out_of_range_point(g, b);
    return;
  }

  const int S = g.S;
  const long long m = PAIRED ? b : b / g.A, t = PAIRED ? (long long)g.tix[b] : b % g.A;
  const double mu = g.mu[m], a = g.a[m];
  const tail::Targets tg = tail::targets(g.tg + t * tail::n_targets(S, g.order), S, g.order);
  const bool two = S == 2, o2 = g.order >= 2;
  const size_t N = g.N, KN = (size_t)(S + 1) * N;
  if constexpr (XA) {
    // x' of the lane's point, once a bin, in its own column of the area:
    // the lanes of a warp form the same bin at each step, and no other
    // lane reads the column, so no barrier follows
    for (int i = 0; i < g.N; ++i) xa[i * PTS] = tail::extrap_x<NC>(lnpi, op, xrows, N, two, o2, a, mu, tg, i);
  }
  const auto xf = [&](int i) {
    if constexpr (XA) return xa[i * PTS];
    else return tail::extrap_x<NC>(lnpi, op, xrows, N, two, o2, a, mu, tg, i);
  };
  const auto kf = [&](int k, int i) { return tail::extrap_key<NC>(krows, N, KN, two, g.khess, tg, k, i); };
  tail::OutSink<2> sink{g.out, b, g.P, S, g.props, g.volume, live, s_tile + threadIdx.x / 32 * tail::ROW_TILE};
  // G = 32: a point's slots are contiguous; else points interleave in the
  // slots, so a group's reads of slot j are one row; or (the wide build at
  // G < 32) they are the lane's own
  int l_mx[SH ? 1 : CAP], l_mn[SH ? 1 : CAP + 1];
  constexpr int pitch = G == 32 || !SH ? 1 : PTS;
  int* mx = !SH ? l_mx : G == 32 ? s_mx + pt * CAP : s_mx + pt;
  int* mn = !SH ? l_mn : G == 32 ? s_mn + pt * (CAP + 1) : s_mn + pt;
  tail::thermo_point<CAP, 4>(xf, kf, tail::group_of<G>(threadIdx.x), g.N, S, g.P, g.smooth, g.props, g.janus, sink, mx, mn, pitch);
}

// One build of the kernel, as a type.
template <int G_, bool PAIRED_, int CAP_, bool XA_>
struct Build {
  static constexpr int G = G_, CAP = CAP_;
  static constexpr bool PAIRED = PAIRED_, XA = XA_;
};

// Dynamic shared bytes of a block: the staged rows, then the x' area.
template <int G, int CAP, bool XA>
size_t dyn_bytes(const Args& g) {
  if constexpr (G == 32) return 0;
  else return (stages<G, CAP, XA>(g) ? row_bytes(g) : 0) + (XA ? xarea_bytes<G>(g.N) : 0);
}

// The kernel with `dyn` bytes of dynamic shared memory allowed; a refused
// opt-in is returned (and cleared from the runtime's last error, so a
// later launch does not report it).  The area's build opts in whatever its
// size (its static slots and dynamic area together may pass 48 KB where
// the dynamic part alone does not) and asks for the SM's whole shared
// memory, so that XA_MIN_BLOCKS of its blocks are resident; the other
// builds opt in only above 48 KB of dynamic memory, which their staging
// rule (counting their static bytes) keeps them under.
template <int G, bool PAIRED, int CAP, bool XA>
cudaError_t allow(size_t dyn) {
  const auto kernel = mb_sweep_thermo_kernel<G, PAIRED, CAP, XA>;
  cudaError_t e = cudaSuccess;
  if (XA) e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout, cudaSharedmemCarveoutMaxShared);
  if (e == cudaSuccess && (XA || dyn > 48 * 1024)) e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
  if (e != cudaSuccess) cudaGetLastError();
  return e;
}

template <int G, bool PAIRED, int CAP, bool XA>
cudaError_t launch(const Args& g, cudaStream_t stream) {
  constexpr int PTS = block_threads<XA>() / G;
  const unsigned blocks = (unsigned)((n_points<PAIRED>(g) + PTS - 1) / PTS);
  const size_t dyn = dyn_bytes<G, CAP, XA>(g);
  const cudaError_t e = allow<G, PAIRED, CAP, XA>(dyn);
  if (e != cudaSuccess) return e;
  mb_sweep_thermo_kernel<G, PAIRED, CAP, XA><<<blocks, block_threads<XA>(), dyn, stream>>>(g);
  return cudaGetLastError();
}

// Blocks of the build an SM holds for this launch (0 for a build the
// library does not have or an area past what a block may opt in to).
template <int G, bool PAIRED, int CAP, bool XA>
int blocks_per_sm(const Args& g) {
  const size_t dyn = dyn_bytes<G, CAP, XA>(g);
  int n = 0;
  if (allow<G, PAIRED, CAP, XA>(dyn) != cudaSuccess) return 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, mb_sweep_thermo_kernel<G, PAIRED, CAP, XA>, block_threads<XA>(), dyn) != cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  return n;
}

// The build for G, the mode and the area (xarea: -1 the library's rule,
// 0 off, 1 on), handed to f; cudaErrorInvalidValue for one the library
// does not have (the area at G = 32).
template <int CAP, typename F>
cudaError_t with_build(int G, bool paired, int xarea, int N, const F& f) {
  const bool xa = xarea < 0 ? xarea_fits<CAP>(G, N) : xarea > 0;
  switch (G) {
    case 1:
      if (xa) return paired ? f(Build<1, true, CAP, true>{}) : f(Build<1, false, CAP, true>{});
      return paired ? f(Build<1, true, CAP, false>{}) : f(Build<1, false, CAP, false>{});
    case 32:
      if (xa) return cudaErrorInvalidValue;
      return paired ? f(Build<32, true, CAP, false>{}) : f(Build<32, false, CAP, false>{});
    default: return cudaErrorInvalidValue;
  }
}

template <typename F>
cudaError_t with_build(int G, int cap, bool paired, int xarea, int N, const F& f) {
  switch (cap) {
    case tail::SMALL: return with_build<tail::SMALL>(G, paired, xarea, N, f);
    case tail::WIDE: return with_build<tail::WIDE>(G, paired, xarea, N, f);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

int mb_sweep_thermo_max_phases() { return tail::WIDE; }

const char* mb_sweep_thermo_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// Launches the kernel's build of `cap` phase slots at G lanes per point on
// `stream` and returns cudaGetLastError() (0 on success;
// cudaErrorInvalidValue for a build the library does not have: G 1 and 32,
// cuda_sweep.LANES; cap 8 and 64, cuda_sweep.CAPACITIES) on `device`, and
// leaves the thread's current device as it found it.  Does not
// synchronise.  All pointers are device pointers (krows may be null
// without props; tix null selects the product mode, else the paired mode
// over M points); the caller has checked shapes, dtypes and bounds.  A
// paired point whose tix lies outside [0, A) comes back invalid (valid 0,
// n_phases 0, mask 0, NaN floats).  khess: the order-2 key-row terms are
// applied.  xarea: -1 the library's rule (mb_sweep_thermo_xarea_fits), 0 x'
// formed on read, 1 the x' area (tests; at G = 32 cudaErrorInvalidValue,
// past what a block may opt in to the opt-in's error).
int mb_sweep_thermo_launch(int device, void* stream, int G, int cap, int xarea, const double* lnpi, const double* op, const double* xrows,
                           const double* krows, const double* volume, const double* mu, const double* a,
                           const double* tg, const int* tix, int M, int A, int N, int S, int P, int smooth, int order, int props,
                           int first_order_mom, int janus, double* fe, int* left, int* right, unsigned char* mask,
                           int* n_phases, unsigned char* valid, double* n_i, double* x_i, double* ntot, double* u,
                           double* density) {
  const fhmc::DeviceGuard on(device);  // the caller's current device is back on every return
  if (on.status() != cudaSuccess) return (int)on.status();
  if (M <= 0 || A <= 0) return 0;
  const int khess = order >= 2 && !first_order_mom;
  const Args g{lnpi, op, xrows, krows, volume, mu, a, tg, tix, M, A, N, S, P, smooth, order, props, khess, janus,
               {fe, left, right, mask, n_phases, valid, n_i, x_i, ntot, u, density}};
  const cudaStream_t st = (cudaStream_t)stream;
  return (int)with_build(G, cap, tix != nullptr, xarea, N, [&](auto b) {
    using B = decltype(b);
    return launch<B::G, B::PAIRED, B::CAP, B::XA>(g, st);
  });
}

// Whether a launch at G lanes a point of the build of `cap` phase slots
// over N bins forms x' once a bin into the area (the library's rule; the
// wrapper's cuda_mb.xarea_fits is held against it).
int mb_sweep_thermo_xarea_fits(int G, int cap, int N) {
  switch (cap) {
    case tail::SMALL: return xarea_fits<tail::SMALL>(G, N);
    case tail::WIDE: return xarea_fits<tail::WIDE>(G, N);
    default: return 0;
  }
}

// Blocks an SM of `device` holds for a launch with these arguments
// (xarea as for the launch): 0 where the library has no such build or a
// block's shared memory passes what it may opt in to.
int mb_sweep_thermo_blocks_per_sm(int device, int G, int cap, int xarea, int paired, int N, int S, int order, int props,
                                  int first_order_mom) {
  const fhmc::DeviceGuard on(device);
  if (on.status() != cudaSuccess) return 0;
  Args g{};
  g.N = N, g.S = S, g.order = order, g.props = props, g.khess = order >= 2 && !first_order_mom;
  int n = 0;
  const cudaError_t e = with_build(G, cap, paired != 0, xarea, N, [&](auto b) {
    using B = decltype(b);
    n = blocks_per_sm<B::G, B::PAIRED, B::CAP, B::XA>(g);
    return cudaSuccess;
  });
  return e == cudaSuccess ? n : 0;
}

// The row former (mb_rows.cuh), which writes the rows this kernel reads.
// Ints in its Table, for the host's check of the layout (cuda_mb.TABLE_INTS).
int mb_rows_table_ints() { return (int)(sizeof(mbrows::Table) / sizeof(int)); }

// Launches the row former over N bins on `stream` and returns
// cudaGetLastError() (0 on success) on `device`, leaving the thread's
// current device as it found it.  Does not synchronise.  table: the host's
// mb_rows_table_ints() ints of the Table (cuda_mb.rows_table), copied
// into the launch's parameters; mom [n_addr, N], op [N], beta [], mu [S]
// are device pointers, as are xrows and krows (null without props); the
// caller has checked shapes, dtypes and devices.
int mb_rows_launch(int device, void* stream, const int* table, const double* mom, const double* op, const double* beta,
                   const double* mu, double* xrows, double* krows, int N) {
  const fhmc::DeviceGuard on(device);  // the caller's current device is back on every return
  if (on.status() != cudaSuccess) return (int)on.status();
  if (N <= 0) return 0;
  mbrows::Table t;
  memcpy(&t, table, sizeof t);
  return (int)mbrows::launch(t, mom, op, beta, mu, xrows, krows, N, (cudaStream_t)stream);
}

}  // extern "C"
