// Fused (mu_1, beta, dMu) extrapolating sweep for Hopper (sm_90a): kernel K2.
//
// Replaces the TPU kernel fhmcanalysis_tpu/core/pallas_mb.py
// (_mb_ds_pallas -> _kernel -> mb_block_lanes -> extrap_source_lanes ->
// thermo_lanes).  What it computes is the float64 semantics of the plain
// version, fhmcanalysis_torch/core/pipeline.py mu_beta_sweep_body, for one
// point (mu_m, beta_t, dMu_t), b = m * A + t, per warp:
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
// What bounds it on the card: the same as K1 -- float64 exp (one per bin
// and point) and the serial segmentation logic.  The rows (up to 7 for x',
// up to 18 for the key rows) are a few KB shared by every point and stay in
// L1/L2; a point's output is ~300 bytes at P=4 with props, which at the
// main path's 4.2M points is the larger floor (PERF.md).  x' and key' are
// recomputed from those rows wherever the tail reads them rather than
// staged, which keeps the kernel free of shared-memory limits in N, at the
// price of ~10 f64 operations per read.
//
// Rounding: x' is formed with __dmul_rn/__dadd_rn in exactly the plain
// version's association (and the library is built with -fmad=false), so
// segmentation agrees bit for bit.  At identity targets every added term
// is an exact zero and the kernel returns K1's output bit for bit.

#include "extrap_rows.cuh"
#include "thermo_tail.cuh"

namespace {

using tail::MAXP;
using tail::WARPS;

struct Args {
  const double* lnpi;    // [N]
  const double* op;      // [N]
  const double* xrows;   // [R, N]: r1, m1 (S=2), then order 2: h00, h01, h11 (S=2)
  const double* krows;   // [G, S+1, N]: key, sgB, sgM (S=2), then sgB2, sgX, sgM2 (S=2)
  const double* volume;  // scalar
  const double* mu;      // [M]
  const double* a;       // [M]
  const double* tg;      // [A, T]: dB, dd (S=2), then order 2: dB^2, 2 dB dd, dd^2 (S=2)
  int M, A, N, S, P, smooth, order, props, khess, janus;
  tail::Out out;
};

// At least 3 blocks per SM (at most 85 registers): without the bound ptxas
// picks fewer registers and spills (PERF.md).
__global__ void __launch_bounds__(32 * WARPS, 3) mb_sweep_thermo_kernel(Args g) {
  __shared__ int s_mx[WARPS][MAXP];
  __shared__ int s_mn[WARPS][MAXP + 1];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long b = (long long)blockIdx.x * WARPS + warp;
  if (b >= (long long)g.M * g.A) return;  // uniform over the warp

  const int S = g.S;
  const long long m = b / g.A, t = b % g.A;
  const double mu = g.mu[m], a = g.a[m];
  const tail::Targets tg = tail::targets(g.tg + t * tail::n_targets(S, g.order), S, g.order);
  const bool two = S == 2, o2 = g.order >= 2;
  const size_t N = g.N, KN = (size_t)(S + 1) * N;
  const auto xf = [&](int i) { return tail::extrap_x(g.lnpi, g.op, g.xrows, N, two, o2, a, mu, tg, i); };
  const auto kf = [&](int k, int i) { return tail::extrap_key(g.krows, N, KN, two, g.khess, tg, k, i); };
  tail::OutSink sink{g.out, b, g.P, S, g.props, g.volume};
  tail::thermo_point(xf, kf, lane, g.N, S, g.P, g.smooth, g.props, g.janus, sink, s_mx[warp], s_mn[warp]);
}

}  // namespace

extern "C" {

int mb_sweep_thermo_max_phases() { return MAXP; }

const char* mb_sweep_thermo_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// Launches the kernel on `stream` and returns cudaGetLastError() (0 on
// success).  Does not synchronise.  All pointers are device pointers
// (krows may be null without props); the caller has checked shapes,
// dtypes and bounds.  khess: the order-2 key-row terms are applied.
int mb_sweep_thermo_launch(int device, void* stream, const double* lnpi, const double* op, const double* xrows,
                           const double* krows, const double* volume, const double* mu, const double* a,
                           const double* tg, int M, int A, int N, int S, int P, int smooth, int order, int props,
                           int first_order_mom, int janus, double* fe, int* left, int* right, unsigned char* mask,
                           int* n_phases, unsigned char* valid, double* n_i, double* x_i, double* ntot, double* u,
                           double* density) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const long long B = (long long)M * A;
  if (B <= 0) return 0;
  const int khess = order >= 2 && !first_order_mom;
  Args g{lnpi, op, xrows, krows, volume, mu, a, tg, M, A, N, S, P, smooth, order, props, khess, janus,
         {fe, left, right, mask, n_phases, valid, n_i, x_i, ntot, u, density}};
  const unsigned blocks = (unsigned)((B + WARPS - 1) / WARPS);
  mb_sweep_thermo_kernel<<<blocks, 32 * WARPS, 0, (cudaStream_t)stream>>>(g);
  return (int)cudaGetLastError();
}

}  // extern "C"
