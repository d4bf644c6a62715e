// Fused binary isopleth cell for Hopper (sm_90a): kernel K3.
//
// Replaces the TPU kernel fhmcanalysis_tpu/core/pallas_iso.py
// (_iso_ds_pallas -> _launch -> _kernel -> iso_block_lanes -> _iso_finish).
// What it computes is the float64 semantics of the plain version,
// fhmcanalysis_torch/binary/isopleth.py iso_grid_body, for one cell
// (mu_1[ix], dMu_2[iy]), b = iy * NX + ix, per warp (the tail's layout
// G = 32 at every N):
//
//   for each side s in {L, R}: source j = lr[iy, s], and x'_s, key'_s as
//     K2 forms them (extrap_rows.cuh) from source j's rows, a[j, ix],
//     mu_1[ix] and the row's target scalars tg[iy, s];
//   the inverse-distance mix x_m = (x'_L w0 + x'_R w1) / (w0 + w1), and
//     key_m the same way (isopleth.py's association);
//   the tail K1 and K2 share (thermo_tail.cuh) on (x_m, key_m), with a
//     sink that keeps only the most stable phase (the first masked slot of
//     least fe) and the final maxima;
//   the finish of the XLA grid engine (fhmcanalysis_tpu binary/isopleth.py
//     _grid_eval): safe = x_m[last maximum] - x_m[N-1] >= cutoff, guard =
//     safe and the two sources' edge flags, ok = valid and guard, the
//     fail code (0 ok, 1 edge, 2 segmentation, 3 phase overflow), and
//     x_1, density, fe of the stable phase, each 0 where not ok.
//
// Like K2 it forms no grand-canonical average: on each side they shift
// x' by a constant over the bins, a mix of two such constants is again
// one, and the tail, is_safe (a difference of two x_m values) and the
// edge flag (computed once per (source, mu_1) in torch and read here) all
// cancel it.  So there is no exp pass beyond the tail's own.
//
// What bounds it on the card: f64 operations, as for K2 -- the tail's
// exp per covered bin, and x_m re-formed from 2 x ~5 rows plus the mix
// (2 products, a sum, a divide) at each of the tail's ~5 reads of a bin;
// in practice the serial per-warp segmentation logic.  The rows are a few
// KB shared by every cell and stay in L1/L2, and a cell writes 29 bytes.
// The design re-reads the rows from global memory rather than staging x_m,
// which keeps the kernel free of a shared-memory ceiling in N (order 2
// runs above the TPU kernel's NPAD 1024) at the price of those
// re-formations.
//
// Rounding: x'_s and the mix are formed with __dmul_rn/__dadd_rn/__ddiv_rn
// (and the library is built with -fmad=false) in the plain version's
// association, so segmentation, valid and the fail code agree bit for bit.

#include "extrap_rows.cuh"
#include "thermo_tail.cuh"

namespace {

using tail::MAXP;
using tail::WARPS;

struct Args {
  const double* lnpi;         // [W, N]
  const double* op;           // [W, N]
  const double* xrows;        // [W, R, N]
  const double* krows;        // [W, G, 3, N]
  const double* a;            // [W, NX]: beta_ref (mu_1 - mu_ref) per source
  const unsigned char* edge;  // [W, NX]: the source's reweighted-tail edge flag
  const double* mu;           // [NX]
  const int* lr;              // [NY, 2]: left / right source per row
  const double* wts;          // [NY, 2]: mixing weights per row
  const double* tg;           // [NY, 2, T]: target scalars per row and side
  const double* volume;       // scalar
  int NX, NY, N, R, G, P, smooth, order, janus;
  double cutoff;
  double* z;                  // [NY, NX] x_1 of the stable phase
  double* rho;                // [NY, NX] its density
  double* fe;                 // [NY, NX] its F.E./kT
  unsigned char* ok;          // [NY, NX]
  int* code;                  // [NY, NX]
};

// Keeps what the finish needs: the stable phase and the last maximum.
struct IsoSink {
  int P;
  const double* volume;
  double best, z, rho, fe;
  int n_max, last_max;
  bool valid;

  __device__ __forceinline__ void phase(int p, int, int, bool mask, double phase_fe, const double* acc) {
    // argmin of where(mask, fe, inf): the first slot of the least value
    const double cand = mask ? phase_fe : INFINITY;
    if (p == 0 || cand < best) {
      double ni[2], nt, u;
      tail::phase_props(acc, 2, ni, nt, u);
      best = cand;
      z = ni[0] / (nt != 0.0 ? nt : 1.0);
      rho = nt / *volume;
      fe = phase_fe;
    }
  }

  __device__ __forceinline__ void finish(int nm, bool v, int lm) {
    n_max = nm;
    valid = v;
    last_max = lm;
  }
};

__global__ void __launch_bounds__(32 * WARPS) iso_grid_kernel(Args g) {
  __shared__ int s_mx[WARPS][MAXP];
  __shared__ int s_mn[WARPS][MAXP + 1];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long b = (long long)blockIdx.x * WARPS + warp;
  if (b >= (long long)g.NY * g.NX) return;  // uniform over the warp

  const int S = 2, N = g.N, T = tail::n_targets(S, g.order);
  const int iy = (int)(b / g.NX), ix = (int)(b % g.NX);
  const int jl = g.lr[2 * iy], jr = g.lr[2 * iy + 1];
  const double w0 = g.wts[2 * iy], w1 = g.wts[2 * iy + 1];
  const double wsum = __dadd_rn(w0, w1);
  const double mu = g.mu[ix];
  const size_t XS = (size_t)g.R * N, KS = (size_t)g.G * (S + 1) * N, KN = (size_t)(S + 1) * N;
  const bool o2 = g.order >= 2;  // nspec 2; the order-2 key-row terms apply with the x' ones
  const tail::Targets tl = tail::targets(g.tg + (size_t)(2 * iy) * T, S, g.order);
  const tail::Targets tr = tail::targets(g.tg + (size_t)(2 * iy + 1) * T, S, g.order);
  const double al = g.a[(size_t)jl * g.NX + ix], ar = g.a[(size_t)jr * g.NX + ix];
  const double *lnl = g.lnpi + (size_t)jl * N, *lnr = g.lnpi + (size_t)jr * N;
  const double *opl = g.op + (size_t)jl * N, *opr = g.op + (size_t)jr * N;
  const double *xl = g.xrows + jl * XS, *xrr = g.xrows + jr * XS;
  const double *kl = g.krows + jl * KS, *krr = g.krows + jr * KS;
  const auto mix = [&](double l, double r) {
    return __ddiv_rn(__dadd_rn(__dmul_rn(l, w0), __dmul_rn(r, w1)), wsum);
  };
  const auto xf = [&](int i) {
    return mix(tail::extrap_x(lnl, opl, xl, N, true, o2, al, mu, tl, i), tail::extrap_x(lnr, opr, xrr, N, true, o2, ar, mu, tr, i));
  };
  const auto kf = [&](int k, int i) {
    return mix(tail::extrap_key(kl, N, KN, true, o2, tl, k, i), tail::extrap_key(krr, N, KN, true, o2, tr, k, i));
  };

  IsoSink sink{g.P, g.volume, INFINITY, 0.0, 0.0, 0.0, 0, 0, false};
  tail::thermo_point(xf, kf, tail::group_of<32>(threadIdx.x), N, S, g.P, g.smooth, 1, g.janus, sink, s_mx[warp], s_mn[warp], 1);

  if (lane == 0) {
    const int lm = min(max(sink.last_max, 0), N - 1);
    const bool safe = __dsub_rn(xf(lm), xf(N - 1)) >= g.cutoff;
    const bool guard = safe && g.edge[(size_t)jl * g.NX + ix] && g.edge[(size_t)jr * g.NX + ix];
    const bool ok = sink.valid && guard;
    g.code[b] = sink.valid ? (guard ? 0 : 1) : (sink.n_max > g.P ? 3 : 2);
    g.ok[b] = ok ? 1 : 0;
    g.z[b] = ok ? sink.z : 0.0;
    g.rho[b] = ok ? sink.rho : 0.0;
    g.fe[b] = ok ? sink.fe : 0.0;
  }
}

}  // namespace

extern "C" {

int iso_grid_max_phases() { return MAXP; }

const char* iso_grid_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// Launches the kernel on `stream` and returns cudaGetLastError() (0 on
// success).  Does not synchronise.  All pointers are device pointers; the
// caller has checked shapes, dtypes and bounds (nspec 2: R = 2 or 5 x-rows
// and G = 3 or 6 key-row groups at order 1 or 2).
int iso_grid_launch(int device, void* stream, const double* lnpi, const double* op, const double* xrows,
                    const double* krows, const double* a, const unsigned char* edge, const double* mu, const int* lr,
                    const double* wts, const double* tg, const double* volume, int NX, int NY, int N, int R, int G,
                    int P, int smooth, int order, int janus, double cutoff, double* z, double* rho, double* fe,
                    unsigned char* ok, int* code) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const long long B = (long long)NX * NY;
  if (B <= 0) return 0;
  Args g{lnpi, op, xrows, krows, a, edge, mu, lr, wts, tg, volume, NX, NY, N, R, G, P, smooth, order, janus,
         cutoff, z, rho, fe, ok, code};
  const unsigned blocks = (unsigned)((B + WARPS - 1) / WARPS);
  iso_grid_kernel<<<blocks, 32 * WARPS, 0, (cudaStream_t)stream>>>(g);
  return (int)cudaGetLastError();
}

}  // extern "C"
