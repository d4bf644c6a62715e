// Fused mu-sweep reweight + segment + per-phase thermo for Hopper (sm_90a).
//
// Replaces the TPU kernel fhmcanalysis_tpu/core/pallas_sweep.py
// (_sweep_ds_pallas -> _kernel -> sweep_block_lanes -> thermo_lanes).  What
// it computes is the float64 semantics of the plain version,
// fhmcanalysis_torch/core/segment.py + pipeline._point_thermo, for one
// state point per group of G lanes:
//
//   x = lnpi + a * op                      (a = beta * (mu - mu0), from torch)
//   then the shared segmentation + integration tail (thermo_tail.cuh):
//   extrema, repairs, janus collect, phase bounds, per-phase sums, and fe,
//   <N_i>, <U>, N_tot, x_i, density.
//
// What bounds it on the card: float64 exp (one per covered bin and point,
// n573) or the ~300 bytes of outputs per point (n31), and in practice the
// serial segmentation logic -- lnpi, op and the key rows are a few KB
// shared by every point and stay in L1/L2.  The kernel is a template on G,
// the lanes per point (thermo_tail.cuh): G = 32 is one point per warp; G =
// 1 runs the segmentation logic once per point instead of on 32 lanes, and
// the wrapper picks it for sweeps large enough to fill the card at one
// lane per point (cuda_sweep.lanes_per_point).  G = 32 reads the rows
// through the read-only cache; at G = 1 the block first stages them in
// shared memory where they fit, so each read of a bin is a shared-memory
// broadcast, which took 4% off n31 and 9% off n573 against __ldg reads
// (PERF.md).  x itself is recomputed wherever it is needed rather than
// staged per point, which keeps the kernel free of shared-memory limits in N.
//
// Capacities: the kernel is also a template on CAP, the phase slots a
// point holds (8 or 64), and KACC, its per-phase sums (4 for nspec 1-2, 6
// for nspec 3-4), so that it answers every max_phases up to 64 and every
// nspec up to 4, as the JAX kernel does; cuda_sweep.capacity and
// cuda_sweep.accumulators pick the smallest build that holds the run.
// CAP 8 with KACC 4 is the kernel as it was before the wide builds.  The
// build of 64 slots runs the tail's wide body (thermo_point_wide) and, at
// G = 1, writes its rows through a 1 KB tile of shared memory a warp
// (s_tile, tail::row_tile_bytes), which counts against the staged rows.
//
// Rounding: x is formed with __dmul_rn/__dadd_rn (and the library is built
// with -fmad=false) so that it is bit-identical to torch's
// `lnpi + a[:, None] * op`: segmentation compares x values exactly.

#include "device_guard.cuh"
#include "thermo_tail.cuh"

namespace {

using tail::THREADS;

struct Args {
  const double* lnpi;
  const double* op;
  const double* keys;    // [S+1, N]: <N_i> rows, then <U> (S <= KACC - 2)
  const double* volume;  // scalar
  const double* a;       // [B]
  int B, N, S, P, smooth, props, janus;
  tail::Out out;
};

// Bytes of the rows a block may stage in shared memory: lnpi, op, keys.
__host__ __device__ __forceinline__ size_t row_bytes(const Args& g) { return (size_t)(g.S + 3) * g.N * sizeof(double); }

template <int G, int CAP, int KACC>
__global__ void __launch_bounds__(THREADS) sweep_thermo_kernel(Args g) {
  constexpr int PTS = THREADS / G;  // points per block
  constexpr bool NC = G == 32;      // rows read through the read-only cache
  constexpr bool SH = tail::slots_shared(G, CAP);
  __shared__ int s_mx[SH ? CAP * PTS : 1];
  __shared__ int s_mn[SH ? (CAP + 1) * PTS : 1];
  constexpr int TILE = tail::row_tile_bytes(G, CAP);
  __shared__ __align__(16) unsigned char s_tile[TILE ? TILE : 1];  // the wide build's row tile (G = 1)
  const int pt = threadIdx.x / G;
  const long long b = (long long)blockIdx.x * PTS + pt;
  const double *lnpi = g.lnpi, *op = g.op, *keys = g.keys;
  if constexpr (G < 32) {
    // the rows, staged in shared memory by the whole block where they fit
    extern __shared__ double s_rows[];
    if (tail::stages_rows<G, CAP>(row_bytes(g), TILE)) {
      tail::stage(s_rows, lnpi, g.N);
      tail::stage(s_rows + g.N, op, g.N);
      tail::stage(s_rows + 2 * g.N, keys, (g.S + 1) * g.N);
      __syncthreads();
      lnpi = s_rows;
      op = s_rows + g.N;
      keys = s_rows + 2 * g.N;
    }
  }
  // G = 1: the warp's lanes that hold a point (the wide build's rows)
  const unsigned live = TILE ? __ballot_sync(tail::FULL, b < g.B) : tail::FULL;
  if (b >= g.B) return;  // G = 32: the warp; else the group, whose collectives name only its lanes
  const double a = g.a[b];
  tail::OutSink<KACC - 2> sink{g.out, b, g.P, g.S, g.props, g.volume, live, s_tile + threadIdx.x / 32 * tail::ROW_TILE};
  const auto xf = [&](int i) { return __dadd_rn(tail::ld<NC>(lnpi, i), __dmul_rn(a, tail::ld<NC>(op, i))); };
  const auto kf = [&](int k, int i) { return tail::ld<NC>(keys, (size_t)k * g.N + i); };
  // G = 32: a point's slots are contiguous; else points interleave in the
  // slots, so a group's reads of slot j are one row; or (the wide build at
  // G < 32) they are the lane's own
  int l_mx[SH ? 1 : CAP], l_mn[SH ? 1 : CAP + 1];
  constexpr int pitch = G == 32 || !SH ? 1 : PTS;
  int* mx = !SH ? l_mx : G == 32 ? s_mx + pt * CAP : s_mx + pt;
  int* mn = !SH ? l_mn : G == 32 ? s_mn + pt * (CAP + 1) : s_mn + pt;
  tail::thermo_point<CAP, KACC>(xf, kf, tail::group_of<G>(threadIdx.x), g.N, g.S, g.P, g.smooth, g.props, g.janus, sink, mx, mn, pitch);
}

template <int G, int CAP, int KACC>
cudaError_t launch(const Args& g, cudaStream_t stream) {
  constexpr int PTS = THREADS / G;
  const unsigned blocks = (unsigned)(((long long)g.B + PTS - 1) / PTS);
  const bool staged = tail::stages_rows<G, CAP>(row_bytes(g), tail::row_tile_bytes(G, CAP));
  sweep_thermo_kernel<G, CAP, KACC><<<blocks, THREADS, staged ? row_bytes(g) : 0, stream>>>(g);
  return cudaGetLastError();
}

template <int CAP, int KACC>
cudaError_t launch_g(int G, const Args& g, cudaStream_t stream) {
  switch (G) {
    case 1: return launch<1, CAP, KACC>(g, stream);
    case 32: return launch<32, CAP, KACC>(g, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

int sweep_thermo_max_phases() { return tail::WIDE; }

int sweep_thermo_max_nspec() { return 4; }

const char* sweep_thermo_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// Launches the kernel's build of `cap` phase slots and `kacc` per-phase
// sums at G lanes per point on `stream` and returns cudaGetLastError() (0
// on success; cudaErrorInvalidValue for a build the library does not have:
// G 1 and 32, cuda_sweep.LANES; cap 8 and 64, cuda_sweep.CAPACITIES; kacc
// 4 and 6) on `device`, and leaves the thread's current device as it found
// it.  Does not synchronise.  All pointers are device pointers; the caller
// has checked shapes, dtypes and bounds (P <= cap, S + 2 <= kacc).
int sweep_thermo_launch(int device, void* stream, int G, int cap, int kacc, const double* lnpi, const double* op, const double* keys,
                        const double* volume, const double* a, int B, int N, int S, int P, int smooth, int props,
                        int janus, double* fe, int* left, int* right, unsigned char* mask, int* n_phases,
                        unsigned char* valid, double* n_i, double* x_i, double* ntot, double* u, double* density) {
  const fhmc::DeviceGuard on(device);  // the caller's current device is back on every return
  if (on.status() != cudaSuccess) return (int)on.status();
  if (B <= 0) return 0;
  const Args g{lnpi, op, keys, volume, a, B, N, S, P, smooth, props, janus,
               {fe, left, right, mask, n_phases, valid, n_i, x_i, ntot, u, density}};
  const cudaStream_t st = (cudaStream_t)stream;
  if (cap == tail::SMALL && kacc == 4) return (int)launch_g<tail::SMALL, 4>(G, g, st);
  if (cap == tail::SMALL && kacc == 6) return (int)launch_g<tail::SMALL, 6>(G, g, st);
  if (cap == tail::WIDE && kacc == 4) return (int)launch_g<tail::WIDE, 4>(G, g, st);
  if (cap == tail::WIDE && kacc == 6) return (int)launch_g<tail::WIDE, 6>(G, g, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
