// The row former: the mu-independent rows of the extrapolating sweep, one
// thread per bin.  Built into K2's library (mb_sweep_thermo.cu, which
// exports mb_rows_launch), so no library more is loaded for it.
//
// It writes what pipeline._mb_rows returns, in cuda_mb's layout (the
// module docstring of core/cuda_mb.py), straight from the histogram:
//
//   xrows [R, N]       r1, mq (S=2), then at order 2: h00, h01, h11 (S=2)
//   krows [G, S+1, N]  key, sgB, sgM (S=2), then with khess: sgB2, sgX, sgM2 (S=2)
//
// Every row is a semigrand (fixed-N) quantity: per bin i it reads the
// moment rows mom[a, i] of a few addresses a, op[i], beta and the
// mu_s - mu_0, and no grand-canonical sum, so the build is one pass over
// the N bins with nothing crossing a bin.  Which moment rows each formula
// reads (DerivEngine's _prod, _xni, the gates of _mb_rows' groups, the
// zero-power rows and the used_ke terms) depends only on (meta, order,
// props, first_order_mom): cuda_mb.rows_table resolves it on the host,
// raising where the plain version raises, and passes it as the kernel
// argument Table.  The kernel then evaluates fixed formulas over it.
//
// Rounding: every product, sum, quotient and reciprocal is rounded on
// its own (__dmul_rn, __dadd_rn, __dsub_rn, __ddiv_rn; the library is
// built with -fmad=false) in the association of the torch code of
// DerivEngine operation by operation: python-float / tensor is torch's
// reciprocal times the float, beta**2 is beta * beta, and a product with
// op^0 = 1.0 is left out (it is exact).  So the rows equal the plain
// _mb_rows bit for bit, and K2 stays bit-equal in segmentation to the
// plain sweep.  tests/test_torch_mb_rows.py builds this header with g++
// for the host (tests/tail_host) and holds it to _mb_rows on the CPU.
//
// What bounds it: launch latency.  It reads and writes tens of KB at
// N = 31 and well under 1 MB at N = 1400, a few hundred f64 operations a
// bin.  It replaces no TPU kernel: the JAX package forms these rows with
// jnp operations inside its jitted sweep.  It exists because the same
// rows as eager torch operations were ~310 launches a call, which left
// the card idle two thirds of the time in the (mu, beta, dMu) sweep.

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace mbrows {

// sgB(b) = DerivEngine.sg_dX_dB(b, 0) of one moment address b.  Indices
// are flat rows of mom viewed as [n_addr, N].
struct SgB {
  int zero;    // b has no power of N or U: the row is 0
  int b, bu;   // m(b), m(b + U)
  int xni[2];  // m(_xni(b, i)), i < S
  int ke;      // b's power of U where used_ke and it is > 0, else 0 (no KE term)
  int bd;      // m(b - U) where ke
};

// sgM(b) = DerivEngine.sg_dX_dMU(0, b) (nspec 2).
struct SgM {
  int zero;  // as SgB's
  int b;     // m(b)
  int xni;   // m(_xni(b, 1))
};

// One address a of the key rows (N_0, N_1 at nspec 2, then U) and what
// its derivative rows read.
struct Slot {
  int m;      // m(a)
  SgB a;      // sgB(a); a.ke, a.bd also the KE term of sgB2(a)
  SgM ma;     // sgM(a)
  SgB au;     // sgB(a*U)
  SgB an[2];  // sgB(a*N_i), i < S
  SgB ad;     // sgB(a - U), read where a.ke
  int pn;     // m(N_1*a), the cross row's own fluctuation
  SgB pnb;    // sgB(N_1*a)
  SgM mn;     // sgM(a*N_1)
};

struct Table {
  int S, order, props, khess;  // khess: the order-2 key rows are formed
  int gate1, gate2;            // max_order >= 2, >= 3: the first- and second-order key rows are not zero
  int key[3];                  // m(N_i), i < S, then m(U) at [S]
  int f11[3];                  // (1,1,1,1,0), (1,1,1,0,0), (1,0,1,1,0): h11's fluctuation (nspec 2)
  Slot slot[3];                // N_i, i < S, then U at [S]
};

// One bin's view of the inputs and the scalars every formula shares.
struct Bin {
  const double* mom;
  size_t N;
  int i;
  double op, beta, dmu[2];  // dmu[s] = mu_s - mu_0, s < S

  __device__ __forceinline__ double m(int a) const { return mom[(size_t)a * N + i]; }
};

// sg_dX_dB(b, 0):  -(m(b+U) - m(b) m(U)) + sum_i dmu_i (m(xni_i) - m(b) m(N_i))
//                  [- (1/(beta beta) * 1.5 ke) op m(b-U)]
template <int S>
__device__ __forceinline__ double sg_b(const Table& t, const Bin& v, const SgB& r) {
  if (r.zero) return 0.0;
  const double mb = v.m(r.b);
  double der = -__dsub_rn(v.m(r.bu), __dmul_rn(mb, v.m(t.key[S])));
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const double f = __dsub_rn(v.m(r.xni[s]), __dmul_rn(mb, v.m(t.key[s])));
    der = __dadd_rn(der, __dmul_rn(v.dmu[s], f));
  }
  if (r.ke) {
    const double c = __dmul_rn(__ddiv_rn(1.0, __dmul_rn(v.beta, v.beta)), 1.5 * r.ke);
    der = __dsub_rn(der, __dmul_rn(__dmul_rn(c, v.op), v.m(r.bd)));
  }
  return der;
}

// sg_dX_dMU(0, b):  beta (m(xni) - m(b) m(N_1))
__device__ __forceinline__ double sg_m(const Table& t, const Bin& v, const SgM& r) {
  if (r.zero) return 0.0;
  return __dmul_rn(v.beta, __dsub_rn(v.m(r.xni), __dmul_rn(v.m(r.b), v.m(t.key[1]))));
}

// The sgB(a) and sgM(a) of the key addresses, formed once a bin and read
// by every row that needs them.
struct Base {
  double sa[3], sm[3];
};

// sg_d2X_dB2(a, 0) of slot k: -df(a, U) + sum_i dmu_i df(a, N_i) [+ KE],
// df(x, y) = (sgB(x*y) - m(x) sgB(y)) - m(y) sgB(x)  (sg_df_dB)
template <int S>
__device__ __forceinline__ double sg_b2(const Table& t, const Bin& v, const Base& e, int k) {
  const Slot& s = t.slot[k];
  const double ma = v.m(s.m);
  const auto df = [&](const SgB& z, int y) {
    return __dsub_rn(__dsub_rn(sg_b<S>(t, v, z), __dmul_rn(ma, e.sa[y])), __dmul_rn(v.m(t.key[y]), e.sa[k]));
  };
  double der = -df(s.au, S);
#pragma unroll
  for (int i = 0; i < S; ++i) der = __dadd_rn(der, __dmul_rn(v.dmu[i], df(s.an[i], i)));
  if (s.a.ke) {
    const double a = __dmul_rn(__dmul_rn(__ddiv_rn(1.0, v.beta), -2.0), v.m(s.a.bd));
    const double b = sg_b<S>(t, v, s.ad);
    const double c = __ddiv_rn(__dmul_rn(v.op, -1.5 * s.a.ke), __dmul_rn(v.beta, v.beta));
    der = __dadd_rn(der, __dmul_rn(c, __dadd_rn(a, b)));
  }
  return der;
}

// The cross row of slot k (nspec 2):  beta df(N_1, a) + (m(N_1*a) - m(N_1) m(a))
__device__ __forceinline__ double cross(const Table& t, const Bin& v, const Base& e, int k) {
  const Slot& s = t.slot[k];
  const double mn = v.m(t.key[1]), ma = v.m(s.m);
  const double f = __dsub_rn(v.m(s.pn), __dmul_rn(mn, ma));
  const double df = __dsub_rn(__dsub_rn(sg_b<2>(t, v, s.pnb), __dmul_rn(mn, e.sa[k])), __dmul_rn(ma, e.sa[1]));
  return __dadd_rn(__dmul_rn(v.beta, df), f);
}

// sg_d2X_dMU2(0, 0, a) of slot k:  beta ((sgM(a*N_1) - m(a) sgM(N_1)) - m(N_1) sgM(a))
__device__ __forceinline__ double sg_m2(const Table& t, const Bin& v, const Base& e, int k) {
  const Slot& s = t.slot[k];
  const double d = __dsub_rn(__dsub_rn(sg_m(t, v, s.mn), __dmul_rn(v.m(s.m), e.sm[1])), __dmul_rn(v.m(t.key[1]), e.sm[k]));
  return __dmul_rn(v.beta, d);
}

// Every row of bin i at nspec S (t.S): mom [n_addr, N], op [N], beta [],
// mu [S]; xrows [R, N], krows [G, S+1, N] (null without props).
template <int S>
__device__ __forceinline__ void form_bin(const Table& t, const double* mom, const double* op, const double* beta, const double* mu,
                                         double* xrows, double* krows, int N, int i) {
  Bin v{mom, (size_t)N, i, op[i], beta[0], {0.0, 0.0}};
#pragma unroll
  for (int s = 0; s < S; ++s) v.dmu[s] = __dsub_rn(mu[s], mu[0]);
  // the slots' sgB(a) wherever a row reads them (the table resolved them there), sgM(a) for the sgM rows
  Base e{{0.0, 0.0, 0.0}, {0.0, 0.0, 0.0}};
  const bool sg1 = t.props && t.gate1;
  if (t.order >= 2 || sg1) {
#pragma unroll
    for (int k = 0; k <= S; ++k) e.sa[k] = sg_b<S>(t, v, t.slot[k].a);
  }
  if (S == 2 && sg1) {
#pragma unroll
    for (int k = 0; k <= S; ++k) e.sm[k] = sg_m(t, v, t.slot[k].ma);
  }
  const size_t n = (size_t)N;
  double* x = xrows + i;
  // r1 = (0 + sum_{s>0} dmu_s n_s) - m(U), and mq = beta n_q
  double acc = 0.0;
#pragma unroll
  for (int s = 1; s < S; ++s) acc = __dadd_rn(acc, __dmul_rn(v.dmu[s], v.m(t.key[s])));
  x[0] = __dsub_rn(acc, v.m(t.key[S]));
  if (S == 2) x[n] = __dmul_rn(v.beta, v.m(t.key[1]));
  if (t.order >= 2) {
    // h00 = (0 + sum_{s>0} dmu_s sgB(N_s)) - sgB(U); h01 = n_1 + beta sgB(N_1); h11 = (beta beta) f11
    acc = 0.0;
#pragma unroll
    for (int s = 1; s < S; ++s) acc = __dadd_rn(acc, __dmul_rn(v.dmu[s], e.sa[s]));
    x[S * n] = __dsub_rn(acc, e.sa[S]);
    if (S == 2) {
      x[3 * n] = __dadd_rn(v.m(t.key[1]), __dmul_rn(v.beta, e.sa[1]));
      const double f11 = __dsub_rn(v.m(t.f11[0]), __dmul_rn(v.m(t.f11[1]), v.m(t.f11[2])));
      x[4 * n] = __dmul_rn(__dmul_rn(v.beta, v.beta), f11);
    }
  }
  if (!t.props) return;
  double* kr = krows + i;
  const size_t grp = (size_t)(S + 1) * n;
#pragma unroll
  for (int k = 0; k <= S; ++k) {
    kr[k * n] = v.m(t.key[k]);
    kr[grp + k * n] = t.gate1 ? e.sa[k] : 0.0;
    if (S == 2) kr[2 * grp + k * n] = t.gate1 ? e.sm[k] : 0.0;
    if (t.khess) {
      kr[(1 + S) * grp + k * n] = t.gate2 ? sg_b2<S>(t, v, e, k) : 0.0;
      if (S == 2) {
        kr[4 * grp + k * n] = t.gate2 ? cross(t, v, e, k) : 0.0;
        kr[5 * grp + k * n] = t.gate2 ? sg_m2(t, v, e, k) : 0.0;
      }
    }
  }
}

// form_bin at the table's nspec (1 or 2).
__device__ __forceinline__ void form_bin(const Table& t, const double* mom, const double* op, const double* beta, const double* mu,
                                         double* xrows, double* krows, int N, int i) {
  if (t.S == 1) form_bin<1>(t, mom, op, beta, mu, xrows, krows, N, i);
  else form_bin<2>(t, mom, op, beta, mu, xrows, krows, N, i);
}

#ifdef __CUDACC__
constexpr int THREADS = 128;

// One thread a bin; neighbouring threads read neighbouring bins of each
// moment row and write neighbouring bins of each output row.  The table
// stays in the kernel's parameter space (__grid_constant__), read by
// reference without a copy.
__global__ void __launch_bounds__(THREADS) mb_rows_kernel(const __grid_constant__ Table t, const double* __restrict__ mom,
                                                          const double* __restrict__ op, const double* __restrict__ beta,
                                                          const double* __restrict__ mu, double* __restrict__ xrows,
                                                          double* __restrict__ krows, int N) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i < N) form_bin(t, mom, op, beta, mu, xrows, krows, N, i);
}

inline cudaError_t launch(const Table& t, const double* mom, const double* op, const double* beta, const double* mu, double* xrows,
                          double* krows, int N, cudaStream_t stream) {
  mb_rows_kernel<<<(unsigned)((N + THREADS - 1) / THREADS), THREADS, 0, stream>>>(t, mom, op, beta, mu, xrows, krows, N);
  return cudaGetLastError();
}
#endif

}  // namespace mbrows
