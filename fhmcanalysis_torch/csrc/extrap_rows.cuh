// One source's Taylor-extrapolated surface, re-formed from its rows per read.
//
// Shared by K2 (mb_sweep_thermo.cu, one source per point) and K3
// (iso_grid.cu, two sources per cell, then mixed).  For one point
// (mu_1, beta_t, dMu_t) of one source, with a = beta_ref (mu_1 - mu_ref)
// and the target scalars tg = dB, dd (S=2), then at order 2 dB^2, 2 dB dd,
// dd^2 (S=2), formed once in torch (pipeline._mb_targets):
//
//   x'(i)  = lnpi + a op + dB (r1 + mu op) + dd m1
//            + [order 2] 0.5 ((dB^2 h00 + 2 dB dd h01) + dd^2 h11)
//   key'_k = key_k + dB sgB_k + dd sgM_k
//            + [khess] 0.5 ((dB^2 sgB2_k + 2 dB dd sgX_k) + dd^2 sgM2_k)
//
// (the dd terms at nspec 2 only) from the mu-independent rows of
// pipeline._mb_rows: xrows [R, N] and krows [G, S+1, N].  The rows are
// passed on every call rather than held in a struct, so K2 hands over its
// kernel parameters as they are: a struct holding copies of them raised
// K2's registers and slowed it (PERF.md).  Every
// product and sum is rounded on its own (__dmul_rn / __dadd_rn, and the
// libraries are built with -fmad=false) in exactly the association of the
// plain versions (pipeline._mb_chunk, binary.isopleth._iso_surfaces), so
// segmentation of x' agrees with them bit for bit.
//
// NC: the rows are in global memory and read through the read-only cache
// (__ldg); K2 at G < 32 passes NC = false with rows it may have staged in
// shared memory (mb_sweep_thermo.cu), read with plain loads (tail::ld).

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

#include "thermo_tail.cuh"

namespace tail {

// Columns of a target row (and rows of xrows): dB, dd, then the order-2 terms.
__host__ __device__ __forceinline__ int n_targets(int S, int order) { return S + (order < 2 ? 0 : (S == 1 ? 1 : 3)); }

// One point's target scalars (zero where the order or nspec has none).
struct Targets {
  double dB, dd, dB2, dBdd2, dd2;
};

__device__ __forceinline__ Targets targets(const double* tg, int S, int order) {
  const bool two = S == 2, o2 = order >= 2;
  return Targets{tg[0], two ? tg[1] : 0.0, o2 ? tg[S] : 0.0, o2 && two ? tg[3] : 0.0, o2 && two ? tg[4] : 0.0};
}

// x'(i) of one source: lnpi, op [N], xr [R, N]; two: nspec 2; o2: order 2.
template <bool NC = true>
__device__ __forceinline__ double extrap_x(const double* lnpi, const double* op, const double* xr, size_t N, bool two,
                                           bool o2, double a, double mu, const Targets& t, int i) {
  double v = __dadd_rn(ld<NC>(lnpi, i), __dmul_rn(a, ld<NC>(op, i)));
  const double tr = __dadd_rn(ld<NC>(xr, i), __dmul_rn(mu, ld<NC>(op, i)));
  v = __dadd_rn(v, __dmul_rn(t.dB, tr));
  if (two) v = __dadd_rn(v, __dmul_rn(t.dd, ld<NC>(xr, N + i)));
  if (o2) {
    double q = __dmul_rn(t.dB2, ld<NC>(xr, (two ? 2 : 1) * N + i));
    if (two) {
      q = __dadd_rn(q, __dmul_rn(t.dBdd2, ld<NC>(xr, 3 * N + i)));
      q = __dadd_rn(q, __dmul_rn(t.dd2, ld<NC>(xr, 4 * N + i)));
    }
    v = __dadd_rn(v, __dmul_rn(0.5, q));
  }
  return v;
}

// key'_k(i) of one source: kr [G, S+1, N], KN = (S+1) N; khess: the
// order-2 key-row terms are applied.
template <bool NC = true>
__device__ __forceinline__ double extrap_key(const double* kr, size_t N, size_t KN, bool two, bool khess,
                                             const Targets& t, int k, int i) {
  const size_t r = (size_t)k * N + i;
  double v = __dadd_rn(ld<NC>(kr, r), __dmul_rn(t.dB, ld<NC>(kr, KN + r)));
  if (two) v = __dadd_rn(v, __dmul_rn(t.dd, ld<NC>(kr, 2 * KN + r)));
  if (khess) {
    double q = __dmul_rn(t.dB2, ld<NC>(kr, (two ? 3 : 2) * KN + r));
    if (two) {
      q = __dadd_rn(q, __dmul_rn(t.dBdd2, ld<NC>(kr, 4 * KN + r)));
      q = __dadd_rn(q, __dmul_rn(t.dd2, ld<NC>(kr, 5 * KN + r)));
    }
    v = __dadd_rn(v, __dmul_rn(0.5, q));
  }
  return v;
}

}  // namespace tail
