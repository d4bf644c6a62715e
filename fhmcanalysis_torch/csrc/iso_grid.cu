// Fused binary isopleth cell for Hopper (sm_90a): kernel K3.
//
// Replaces the TPU kernel fhmcanalysis_tpu/core/pallas_iso.py
// (_iso_ds_pallas -> _launch -> _kernel -> iso_block_lanes -> _iso_finish).
// What it computes is the float64 semantics of the plain version,
// fhmcanalysis_torch/binary/isopleth.py iso_grid_body, for one cell
// (mu_1[ix], dMu_2[iy]), b = iy * NX + ix, per group of G lanes:
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
// What bounds it on the card: f64 operations, as for K2 -- the tail's exp
// per covered bin, and x_m re-formed from 2 x ~5 rows plus the mix (2
// products, a sum, a divide) at each of the tail's ~5 reads of a bin -- and
// in practice the serial segmentation logic.  A cell writes 29 bytes.
//
// The layout is a template on G, the lanes per cell, as for K1 and K2
// (cuda_iso.lanes_per_cell picks it).  G = 32 is one cell per warp and
// reads the rows through the read-only cache.  G = 1 is one cell per lane,
// 256 cells a block, so the segmentation logic runs once per cell with 32
// cells to a warp instruction; its lane walks the cell's bins serially, so
// every re-formation of x_m is now that lane's own work.  Consecutive cells
// share the row iy, so at G = 1 the lanes of a warp read the same bin of
// the same sources at the same step, and a block stages the rows (lnpi,
// op, xrows, krows) of the sources its cells name in shared memory where
// they fit: those are the distinct lr entries of the rows the block spans,
// and the launch sizes the staging area for at most min(W, 2 x those
// rows) sources (2 rows, so 2-4 sources, once NX >= 256; more on narrow
// grids), not for all W sources, so that a grid of many sources still
// stages the few each block needs.  The rule is K2's (tail::stages_rows:
// the rows and the index slots within 48 KB): at N = 31 the 2 sources of
// a wide grid take 6.4 KB at order 1 and 12.4 KB at order 2; at N = 1400
// one source takes 146 KB and the rows stay in global memory.
//
// Capacities: a second template argument, CAP, is the phase slots a cell
// holds (8 or 64; thermo_tail.cuh), so that K3 answers every max_phases up
// to 64 as the JAX kernel does -- the remedy binary/isopleth.py gives for
// fail code 3; cuda_sweep.capacity picks the smallest build that holds the
// run, and CAP 8 is the kernel as it was before the wide build.  The wide
// build at G = 1 keeps a cell's index slots in its lane's local memory, so
// the staging rule (tail::stages_rows) gives its rows the whole 48 KB.
//
// Rounding: x'_s and the mix are formed with __dmul_rn/__dadd_rn/__ddiv_rn
// (and the library is built with -fmad=false) in the plain version's
// association, so segmentation, valid and the fail code agree bit for bit
// at every G; the tail's sums, and so the floats, depend on G in the last
// bits.

#include "device_guard.cuh"
#include "extrap_rows.cuh"
#include "thermo_tail.cuh"

namespace {

using tail::THREADS;

// Sources a block at G = 1 may stage.
constexpr int MAX_STAGED = 32;
// Static shared bytes of the staged-source list (s_src, s_cnt): 132,
// rounded up to 16 as ptxas rounds a block's static area for the 16-byte
// aligned dynamic rows that follow it (the index slots are multiples of
// 16 already), so that the staging rule counts what the launch reserves.
constexpr size_t LIST_BYTES = (sizeof(int) * (MAX_STAGED + 1) + 15) / 16 * 16;
// Blocks per SM the G = 1 layout is built for: 2 (at most 128 registers,
// 64 bytes of spill) ran as fast as 3 (80 registers, 508 bytes of spill),
// and 1 (148 registers, no spill) 25-30% slower on iso31 (PERF.md).  The
// wide build at G = 32 asks for 2 as well: left free, ptxas gave it 142
// registers, one block an SM, and overflow31 at 16 slots ran 9.5 ms
// against 5.9 at 128 registers (PERF.md).
constexpr int G1_MIN_BLOCKS = 2;
constexpr int WIDE_G32_MIN_BLOCKS = 2;

struct Args {
  const double* lnpi;         // [W, N]
  const double* op;           // [W, N]
  const double* xrows;        // [W, R, N]
  const double* krows;        // [W, KG, 3, N]
  const double* a;            // [W, NX]: beta_ref (mu_1 - mu_ref) per source
  const unsigned char* edge;  // [W, NX]: the source's reweighted-tail edge flag
  const double* mu;           // [NX]
  const int* lr;              // [NY, 2]: left / right source per row
  const double* wts;          // [NY, 2]: mixing weights per row
  const double* tg;           // [NY, 2, T]: target scalars per row and side
  const double* volume;       // scalar
  int W, NX, NY, N, R, KG, P, smooth, order, janus;
  double cutoff;
  int staged;                 // sources a block stages in shared memory (G = 1), 0: none
  double* z;                  // [NY, NX] x_1 of the stable phase
  double* rho;                // [NY, NX] its density
  double* fe;                 // [NY, NX] its F.E./kT
  unsigned char* ok;          // [NY, NX]
  int* code;                  // [NY, NX]
};

// One source's rows, in global memory or in a block's staged copy.
struct Rows {
  const double *lnpi, *op, *x, *k;
};

// Doubles of one source's rows: lnpi, op, xrows, krows.
__host__ __device__ __forceinline__ size_t source_doubles(const Args& g) {
  return (size_t)(2 + g.R + 3 * g.KG) * g.N;
}

__device__ __forceinline__ Rows global_rows(const Args& g, int j) {
  const size_t N = g.N;
  return Rows{g.lnpi + j * N, g.op + j * N, g.xrows + j * g.R * N, g.krows + j * g.KG * 3 * N};
}

// Slot k of a staged area: source_doubles per source, its rows in Rows' order.
__device__ __forceinline__ Rows staged_rows(const double* s, const Args& g, int k) {
  const size_t N = g.N;
  const double* base = s + k * source_doubles(g);
  return Rows{base, base + N, base + 2 * N, base + (2 + g.R) * N};
}

// The block's copy of source j's rows into a slot of the staged area.
__device__ __forceinline__ void stage_source(double* dst, const Args& g, int j) {
  const Rows src = global_rows(g, j);
  const int N = g.N;
  tail::stage(dst, src.lnpi, N);
  tail::stage(dst + N, src.op, N);
  tail::stage(dst + 2 * N, src.x, g.R * N);
  tail::stage(dst + (2 + g.R) * N, src.k, g.KG * 3 * N);
}

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

  // the wide build's row: its masked phases, from the group's first lane
  // (a slot past the count is unmasked, so never the stable phase)
  static constexpr bool ROW_ON_EVERY_LANE = false;
  template <int G, int CAP, int KACC>
  __device__ __forceinline__ void row(const tail::Group<G>& grp, const tail::WideRow<CAP, KACC>& w) {
    if (grp.lane == 0)
      for (int p = 0; p < w.nmask; ++p) phase(p, w.lo[p], w.hi[p], true, w.phase_fe(p), w.acc[p]);
  }
};

template <int G, int CAP>
__global__ void __launch_bounds__(THREADS, G == 1 ? G1_MIN_BLOCKS : (CAP > tail::SMALL ? WIDE_G32_MIN_BLOCKS : 1)) iso_grid_kernel(Args g) {
  constexpr int PTS = THREADS / G;  // cells per block
  constexpr bool NC = G == 32;      // rows read through the read-only cache
  constexpr bool SH = tail::slots_shared(G, CAP);
  __shared__ int s_mx[SH ? CAP * PTS : 1];
  __shared__ int s_mn[SH ? (CAP + 1) * PTS : 1];
  extern __shared__ double s_rows[];  // the staged sources' rows (G < 32)
  __shared__ int s_src[MAX_STAGED];   // which sources they are
  __shared__ int s_cnt;               // how many
  const bool staged = G < 32 && g.staged;
  const int pt = threadIdx.x / G;
  const long long B = (long long)g.NY * g.NX;
  const long long b = (long long)blockIdx.x * PTS + pt;
  if (staged) {
    // the distinct sources named by the rows the block's cells span
    if (threadIdx.x == 0) {
      const long long first = (long long)blockIdx.x * PTS, last = min(B, first + PTS) - 1;
      int cnt = 0;
      for (long long r = first / g.NX; r <= last / g.NX; ++r)
        for (int s = 0; s < 2; ++s) {
          const int j = g.lr[2 * r + s];
          bool seen = false;
          for (int k = 0; k < cnt; ++k) seen = seen || s_src[k] == j;
          if (!seen) s_src[cnt++] = j;
        }
      s_cnt = cnt;
    }
    __syncthreads();
    for (int k = 0; k < s_cnt; ++k) stage_source(s_rows + k * source_doubles(g), g, s_src[k]);
    __syncthreads();
  }
  if (b >= B) return;  // after the block's barriers; nothing below is block-wide (G = 32: uniform over the warp)

  const int iy = (int)(b / g.NX), ix = (int)(b % g.NX);
  const int jl = g.lr[2 * iy], jr = g.lr[2 * iy + 1];
  Rows rl = global_rows(g, jl), rr = global_rows(g, jr);  // the left and right source's rows
  if (staged) {
    int kl = 0, kr = 0;
    for (int k = 0; k < s_cnt; ++k) {
      if (s_src[k] == jl) kl = k;
      if (s_src[k] == jr) kr = k;
    }
    rl = staged_rows(s_rows, g, kl);
    rr = staged_rows(s_rows, g, kr);
  }

  // the cell's scalars, once per lane
  const int S = 2, N = g.N, T = tail::n_targets(S, g.order);
  const double w0 = g.wts[2 * iy], w1 = g.wts[2 * iy + 1];
  const double wsum = __dadd_rn(w0, w1);
  const double mu = g.mu[ix];
  const size_t KN = (size_t)(S + 1) * N;
  const bool o2 = g.order >= 2;  // nspec 2; the order-2 key-row terms apply with the x' ones
  const tail::Targets tl = tail::targets(g.tg + (size_t)(2 * iy) * T, S, g.order);
  const tail::Targets tr = tail::targets(g.tg + (size_t)(2 * iy + 1) * T, S, g.order);
  const double al = g.a[(size_t)jl * g.NX + ix], ar = g.a[(size_t)jr * g.NX + ix];
  const auto mix = [&](double l, double r) {
    return __ddiv_rn(__dadd_rn(__dmul_rn(l, w0), __dmul_rn(r, w1)), wsum);
  };
  const auto xf = [&](int i) {
    return mix(tail::extrap_x<NC>(rl.lnpi, rl.op, rl.x, N, true, o2, al, mu, tl, i),
               tail::extrap_x<NC>(rr.lnpi, rr.op, rr.x, N, true, o2, ar, mu, tr, i));
  };
  const auto kf = [&](int k, int i) {
    return mix(tail::extrap_key<NC>(rl.k, N, KN, true, o2, tl, k, i), tail::extrap_key<NC>(rr.k, N, KN, true, o2, tr, k, i));
  };

  IsoSink sink{g.P, g.volume, INFINITY, 0.0, 0.0, 0.0, 0, 0, false};
  // G = 32: a cell's slots are contiguous; else cells interleave in the
  // slots, so a group's reads of slot j are one row; or (the wide build at
  // G < 32) they are the lane's own
  int l_mx[SH ? 1 : CAP], l_mn[SH ? 1 : CAP + 1];
  constexpr int pitch = G == 32 || !SH ? 1 : PTS;
  int* mx = !SH ? l_mx : G == 32 ? s_mx + pt * CAP : s_mx + pt;
  int* mn = !SH ? l_mn : G == 32 ? s_mn + pt * (CAP + 1) : s_mn + pt;
  const tail::Group<G> grp = tail::group_of<G>(threadIdx.x);
  tail::thermo_point<CAP, 4>(xf, kf, grp, N, S, g.P, g.smooth, 1, g.janus, sink, mx, mn, pitch);

  if (grp.lane == 0) {
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

// Sources a block stages at G < 32 (0: none): its THREADS / G consecutive
// cells span at most (THREADS / G - 1) / NX + 2 rows, each naming 2 sources
// (cuda_iso.staged_sources reports the same).
template <int G, int CAP>
int staged_sources(const Args& g) {
  const int span = (THREADS / G - 1) / g.NX + 2;
  const int rows = span < g.NY ? span : g.NY;
  const int k = 2 * rows < g.W ? 2 * rows : g.W;
  const size_t bytes = k * source_doubles(g) * sizeof(double) + LIST_BYTES;
  return k <= MAX_STAGED && tail::stages_rows<G, CAP>(bytes) ? k : 0;
}

template <int G, int CAP>
cudaError_t launch(Args g, cudaStream_t stream) {
  constexpr int PTS = THREADS / G;
  g.staged = G < 32 ? staged_sources<G, CAP>(g) : 0;
  const long long B = (long long)g.NX * g.NY;
  const unsigned blocks = (unsigned)((B + PTS - 1) / PTS);
  iso_grid_kernel<G, CAP><<<blocks, THREADS, g.staged * source_doubles(g) * sizeof(double), stream>>>(g);
  return cudaGetLastError();
}

template <int CAP>
cudaError_t launch_g(int G, const Args& g, cudaStream_t stream) {
  switch (G) {
    case 1: return launch<1, CAP>(g, stream);
    case 32: return launch<32, CAP>(g, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

int iso_grid_max_phases() { return tail::WIDE; }

const char* iso_grid_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// Sources a block of the build of `cap` phase slots stages in shared
// memory at G lanes per cell for this grid (0: the rows stay in global
// memory); the wrapper's report is held against it.
int iso_grid_staged_sources(int G, int cap, int W, int NX, int NY, int N, int R, int KG) {
  Args g{};
  g.W = W, g.NX = NX, g.NY = NY, g.N = N, g.R = R, g.KG = KG;
  if (G != 1) return 0;
  return cap == tail::WIDE ? staged_sources<1, tail::WIDE>(g) : staged_sources<1, tail::SMALL>(g);
}

// Launches the kernel's build of `cap` phase slots at G lanes per cell on
// `stream` and returns cudaGetLastError() (0 on success;
// cudaErrorInvalidValue for a build the library does not have: G 1 and 32,
// cuda_sweep.LANES; cap 8 and 64, cuda_sweep.CAPACITIES) on `device`, and
// leaves the thread's current device as it found it.  Does not
// synchronise.  All pointers are device pointers; the caller has checked
// shapes, dtypes and bounds (nspec 2: R = 2 or 5 x-rows and KG = 3 or 6
// key-row groups at order 1 or 2).
int iso_grid_launch(int device, void* stream, int G, int cap, const double* lnpi, const double* op, const double* xrows,
                    const double* krows, const double* a, const unsigned char* edge, const double* mu, const int* lr,
                    const double* wts, const double* tg, const double* volume, int W, int NX, int NY, int N, int R,
                    int KG, int P, int smooth, int order, int janus, double cutoff, double* z, double* rho, double* fe,
                    unsigned char* ok, int* code) {
  const fhmc::DeviceGuard on(device);  // the caller's current device is back on every return
  if (on.status() != cudaSuccess) return (int)on.status();
  const long long B = (long long)NX * NY;
  if (B <= 0) return 0;
  const Args g{lnpi, op, xrows, krows, a, edge, mu, lr, wts, tg, volume, W, NX, NY, N, R, KG, P, smooth, order, janus,
               cutoff, 0, z, rho, fe, ok, code};
  const cudaStream_t st = (cudaStream_t)stream;
  switch (cap) {
    case tail::SMALL: return (int)launch_g<tail::SMALL>(G, g, st);
    case tail::WIDE: return (int)launch_g<tail::WIDE>(G, g, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
