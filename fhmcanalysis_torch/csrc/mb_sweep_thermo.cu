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
// and point) and the serial segmentation logic.  The rows (up to 7 for x',
// up to 18 for the key rows) are a few KB shared by every point; a point's
// output is ~300 bytes at P=4 with props, which at the main path's 4.2M
// points is the larger floor (PERF.md).  x' and key' are recomputed from
// those rows wherever the tail reads them rather than staged per point,
// which keeps the kernel free of shared-memory limits in N, at the price
// of ~10 f64 operations per read.  The layout is K1's: a template on G,
// the lanes per point, with G picked by the same rule
// (cuda_sweep.lanes_per_point); G = 32 reads the rows through the
// read-only cache, G = 1 stages them in shared memory where they fit
// (about 6 KB at N = 31), which took 6-14% off mb31 (PERF.md).
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

// At least 3 blocks per SM (at most 85 registers) at both G: at G = 32
// without the bound ptxas picks fewer registers and spills; at G = 1 it
// takes 93 registers (2 blocks per SM) and runs 13-15% slower at mb31_o1,
// while 4 blocks (64 registers) spill (PERF.md).
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

template <int G, bool PAIRED, int CAP>
__global__ void __launch_bounds__(THREADS, 3) mb_sweep_thermo_kernel(Args g) {
  constexpr int PTS = THREADS / G;  // points per block
  constexpr bool NC = G == 32;      // rows read through the read-only cache
  constexpr bool SH = tail::slots_shared(G, CAP);
  __shared__ int s_mx[SH ? CAP * PTS : 1];
  __shared__ int s_mn[SH ? (CAP + 1) * PTS : 1];
  constexpr int TILE = tail::row_tile_bytes(G, CAP);
  __shared__ __align__(16) unsigned char s_tile[TILE ? TILE : 1];  // the wide build's row tile (G = 1)
  const int pt = threadIdx.x / G;
  const long long b = (long long)blockIdx.x * PTS + pt;
  const double *lnpi = g.lnpi, *op = g.op, *xrows = g.xrows, *krows = g.krows;
  if constexpr (G < 32) {
    // the rows, staged in shared memory by the whole block where they fit
    extern __shared__ double s_rows[];
    if (tail::stages_rows<G, CAP>(row_bytes(g), TILE)) {
      const int N = g.N, XN = x_rows(g) * N;
      tail::stage(s_rows, lnpi, N);
      tail::stage(s_rows + N, op, N);
      tail::stage(s_rows + 2 * N, xrows, XN);
      tail::stage(s_rows + 2 * N + XN, krows, k_rows(g) * N);
      __syncthreads();
      lnpi = s_rows;
      op = s_rows + N;
      xrows = s_rows + 2 * N;
      krows = s_rows + 2 * N + XN;
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
  const auto xf = [&](int i) { return tail::extrap_x<NC>(lnpi, op, xrows, N, two, o2, a, mu, tg, i); };
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

template <int G, bool PAIRED, int CAP>
cudaError_t launch(const Args& g, cudaStream_t stream) {
  constexpr int PTS = THREADS / G;
  const unsigned blocks = (unsigned)((n_points<PAIRED>(g) + PTS - 1) / PTS);
  const bool staged = tail::stages_rows<G, CAP>(row_bytes(g), tail::row_tile_bytes(G, CAP));
  mb_sweep_thermo_kernel<G, PAIRED, CAP><<<blocks, THREADS, staged ? row_bytes(g) : 0, stream>>>(g);
  return cudaGetLastError();
}

template <int CAP>
cudaError_t launch_g(int G, bool paired, const Args& g, cudaStream_t stream) {
  switch (G) {
    case 1: return paired ? launch<1, true, CAP>(g, stream) : launch<1, false, CAP>(g, stream);
    case 32: return paired ? launch<32, true, CAP>(g, stream) : launch<32, false, CAP>(g, stream);
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
// applied.
int mb_sweep_thermo_launch(int device, void* stream, int G, int cap, const double* lnpi, const double* op, const double* xrows,
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
  const bool paired = tix != nullptr;
  switch (cap) {
    case tail::SMALL: return (int)launch_g<tail::SMALL>(G, paired, g, st);
    case tail::WIDE: return (int)launch_g<tail::WIDE>(G, paired, g, st);
    default: return (int)cudaErrorInvalidValue;
  }
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
