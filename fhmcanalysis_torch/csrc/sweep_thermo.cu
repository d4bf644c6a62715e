// Fused mu-sweep reweight + segment + per-phase thermo for Hopper (sm_90a).
//
// Replaces the TPU kernel fhmcanalysis_tpu/core/pallas_sweep.py
// (_sweep_ds_pallas -> _kernel -> sweep_block_lanes -> thermo_lanes).  What
// it computes is the float64 semantics of the plain version,
// fhmcanalysis_torch/core/segment.py + pipeline._point_thermo, for one
// state point per warp:
//
//   x = lnpi + a * op                      (a = beta * (mu - mu0), from torch)
//   then the shared segmentation + integration tail (thermo_tail.cuh):
//   extrema, repairs, janus collect, phase bounds, per-phase sums, and fe,
//   <N_i>, <U>, N_tot, x_i, density.
//
// What bounds it on the card: float64 exp (one per covered bin and point,
// n573) or the ~300 bytes of outputs per point (n31), and in practice the
// serial segmentation logic -- lnpi, op and the key rows are a few KB
// shared by every point and stay in L1/L2.  The tail's header says how the
// warp layout answers that; x is recomputed from global memory where it is
// needed rather than staged, which keeps the kernel free of shared-memory
// limits in N.
//
// Rounding: x is formed with __dmul_rn/__dadd_rn (and the library is built
// with -fmad=false) so that it is bit-identical to torch's
// `lnpi + a[:, None] * op`: segmentation compares x values exactly.

#include "thermo_tail.cuh"

namespace {

using tail::MAXP;
using tail::WARPS;

struct Args {
  const double* lnpi;
  const double* op;
  const double* keys;    // [S+1, N]: <N_i> rows, then <U>
  const double* volume;  // scalar
  const double* a;       // [B]
  int B, N, S, P, smooth, props, janus;
  tail::Out out;
};

__device__ __forceinline__ double xval(const Args& g, double a, int i) {
  return __dadd_rn(__ldg(g.lnpi + i), __dmul_rn(a, __ldg(g.op + i)));
}

__global__ void __launch_bounds__(32 * WARPS) sweep_thermo_kernel(Args g) {
  __shared__ int s_mx[WARPS][MAXP];
  __shared__ int s_mn[WARPS][MAXP + 1];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long b = (long long)blockIdx.x * WARPS + warp;
  if (b >= g.B) return;  // uniform over the warp

  const double a = g.a[b];
  const auto xf = [&](int i) { return xval(g, a, i); };
  const auto kf = [&](int k, int i) { return __ldg(g.keys + (size_t)k * g.N + i); };
  tail::OutSink sink{g.out, b, g.P, g.S, g.props, g.volume};
  tail::thermo_point(xf, kf, lane, g.N, g.S, g.P, g.smooth, g.props, g.janus, sink, s_mx[warp], s_mn[warp]);
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
  Args g{lnpi, op, keys, volume, a, B, N, S, P, smooth, props, janus,
         {fe, left, right, mask, n_phases, valid, n_i, x_i, ntot, u, density}};
  const unsigned blocks = (unsigned)((B + WARPS - 1) / WARPS);
  sweep_thermo_kernel<<<blocks, 32 * WARPS, 0, (cudaStream_t)stream>>>(g);
  return (int)cudaGetLastError();
}

}  // extern "C"
