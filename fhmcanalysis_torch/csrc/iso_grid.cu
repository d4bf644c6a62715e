// Fused binary isopleth cell for Hopper (sm_90a): kernel K3.
//
// Replaces the TPU kernel fhmcanalysis_tpu/core/pallas_iso.py
// (_iso_ds_pallas -> _launch -> _kernel -> iso_block_lanes -> _iso_finish).
// What it computes is the float64 semantics of the plain version,
// fhmcanalysis_torch/binary/isopleth.py iso_grid_body, for one cell
// (mu_1[ix], dMu_2[iy]), b = iy * NX + ix, per group of G lanes: the two
// sides' x' and key', their inverse-distance mix, the tail K1 and K2 share
// and the XLA grid engine's finish (fhmcanalysis_tpu binary/isopleth.py
// _grid_eval), as iso_cell.cuh sets out; this file stages the rows, lays
// the cells out and launches.
//
// Like K2 it forms no grand-canonical average: on each side they shift
// x' by a constant over the bins, a mix of two such constants is again
// one, and the tail, is_safe (a difference of two x_m values) and the
// edge flag (computed once per (source, mu_1) in torch and read here) all
// cancel it.  So there is no exp pass beyond the tail's own.
//
// What bounds it on the card: f64 operations, as for K2 -- the tail's exp
// per covered bin, and x_m formed from 2 x ~5 rows plus the mix (2
// products, a sum, a divide) -- and in practice the serial segmentation
// logic.  A cell writes 29 bytes.
//
// The layout is a template on G, the lanes per cell, as for K1 and K2
// (cuda_iso.lanes_per_cell picks it).  G = 32 is one cell per warp and
// reads the rows through the read-only cache.  G = 1 is one cell per lane,
// 256 cells a block, so the segmentation logic runs once per cell with 32
// cells to a warp instruction; its lane walks the cell's bins serially.
// Consecutive cells share the row iy, so at G = 1 the lanes of a warp read
// the same bin of the same sources at the same step, and a block stages
// the rows (lnpi, op, xrows, krows) of the sources its cells name in
// shared memory where they fit: those are the distinct lr entries of the
// rows the block spans, and the launch sizes the staging area for at most
// min(W, 2 x those rows) sources (2 rows, so 2-4 sources, once NX >= 256;
// more on narrow grids), not for all W sources, so that a grid of many
// sources still stages the few each block needs.  The rule is K2's
// (tail::stages_rows: the rows and the index slots within 48 KB): at N =
// 31 the 2 sources of a wide grid take 6.4 KB at order 1 and 12.4 KB at
// order 2; at N = 1400 one source takes 146 KB and the rows stay in
// global memory.
//
// Capacities: a second template argument, CAP, is the phase slots a cell
// holds (8 or 64; thermo_tail.cuh), so that K3 answers every max_phases up
// to 64 as the JAX kernel does -- the remedy binary/isopleth.py gives for
// fail code 3; launch.capacity picks the smallest build that holds the
// run, and CAP 8 is the kernel as it was before the wide build: it forms
// x_m wherever the tail reads it.
//
// The wide build (CAP 64) has a layout of its own.  Its tail reads x at a
// bin about 8 times at smooth 1 and 10 at smooth 2 (the stencil, the
// repairs, the per-phase maxima, the ends, the exp pass), and at G = 32
// the 32 lanes of a cell re-formed the same x_m at every step of the
// serial logic.  So a block of the wide build forms each cell's x_m once
// per bin into an area of dynamic shared memory (a third template
// argument, XM), THREADS/G cells of N doubles after the staged rows, and
// the tail and the finish read it from there: at G = 32 a cell's bins are
// contiguous, formed by its warp's lanes at bins lane, lane + 32, ...;
// at G = 1 they interleave by cell (bin i of cell c at i * 256 + c), each
// lane forms its own, and a warp's reads are conflict-free whatever bins
// its lanes read (a 64-bit access is served per half-warp, and the bank
// of a slot depends only on c).  The area is 63.5 KB a block at G = 1 and
// N = 31 and 89.6 KB at G = 32 and N = 1400; above 48 KB the launch opts
// in (cudaFuncSetAttribute) and returns its error.  Where the block's
// static slots, its staged rows and the area pass SMEM_OPTIN, what a
// Hopper block may opt in to (G = 1 from N = 95-114, by the rows it
// stages; G = 32 from N = 3,568),
// the build forms x_m on read as the first build does: a layout decided
// on the host (iso_cell.cuh xm_bytes; the library's iso_grid_xm_bytes
// says what it decided).  The wide build at
// G = 1 keeps a cell's index slots in its lane's local memory, so the
// staging rule (tail::stages_rows) gives its rows the whole 48 KB.
//
// Rounding: x'_s and the mix are formed with __dmul_rn/__dadd_rn/__ddiv_rn
// (and the library is built with -fmad=false) in the plain version's
// association, so segmentation, valid and the fail code agree bit for bit
// at every G, and x_m read from the area is the double formed on read;
// the tail's sums, and so the floats, depend on G in the last bits.

#include "device_guard.cuh"
#include "iso_cell.cuh"

namespace {

using iso::Args;
using iso::MAX_STAGED;
using iso::Rows;
using iso::source_doubles;
using iso::staged_sources;
using iso::xm_area;
using iso::xm_bytes;
using tail::THREADS;

// Blocks per SM the G = 1 layout is built for: 2 (at most 128 registers,
// 64 bytes of spill) ran as fast as 3 (80 registers, 508 bytes of spill),
// and 1 (148 registers, no spill) 25-30% slower on iso31 (PERF.md).  The
// wide build at G = 32 asks for 2 as well: left free, ptxas gave it 142
// registers, one block an SM, and overflow31 at 16 slots ran 9.5 ms
// against 5.9 at 128 registers (PERF.md).  With the x_m area, 2 is also
// what the shared memory allows at G = 1 and N = 31 (63.5 KB and the
// staged rows a block) and at G = 32 and N = 1400 (89.6 KB).
constexpr int G1_MIN_BLOCKS = 2;
constexpr int WIDE_G32_MIN_BLOCKS = 2;

template <int G, int CAP>
constexpr int min_blocks() {
  return G == 1 ? G1_MIN_BLOCKS : (CAP > tail::SMALL ? WIDE_G32_MIN_BLOCKS : 1);
}

// Slot k of a staged area: source_doubles per source, its rows in Rows' order.
__device__ __forceinline__ Rows staged_rows(const double* s, const Args& g, int k) {
  const size_t N = g.N;
  const double* base = s + k * source_doubles(g);
  return Rows{base, base + N, base + 2 * N, base + (2 + g.R) * N};
}

// The block's copy of source j's rows into a slot of the staged area.
__device__ __forceinline__ void stage_source(double* dst, const Args& g, int j) {
  const Rows src = iso::global_rows(g, j);
  const int N = g.N;
  tail::stage(dst, src.lnpi, N);
  tail::stage(dst + N, src.op, N);
  tail::stage(dst + 2 * N, src.x, g.R * N);
  tail::stage(dst + (2 + g.R) * N, src.k, g.KG * 3 * N);
}

template <int G, int CAP, bool XM>
__global__ void __launch_bounds__(THREADS, min_blocks<G, CAP>()) iso_grid_kernel(Args g) {
  static_assert(!XM || CAP > tail::SMALL, "the x_m area is the wide build's");
  constexpr int PTS = THREADS / G;  // cells per block
  constexpr bool NC = G == 32;      // rows read through the read-only cache
  constexpr bool SH = tail::slots_shared(G, CAP);
  __shared__ int s_mx[SH ? CAP * PTS : 1];
  __shared__ int s_mn[SH ? (CAP + 1) * PTS : 1];
  extern __shared__ double s_dyn[];  // the staged sources' rows (G < 32), then the cells' x_m (XM)
  __shared__ int s_src[MAX_STAGED];  // which sources they are
  __shared__ int s_cnt;              // how many
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
    for (int k = 0; k < s_cnt; ++k) stage_source(s_dyn + k * source_doubles(g), g, s_src[k]);
    __syncthreads();
  }
  if (b >= B) return;  // after the block's barriers; nothing below is block-wide (G = 32: uniform over the warp)

  const int iy = (int)(b / g.NX), ix = (int)(b % g.NX);
  const int jl = g.lr[2 * iy], jr = g.lr[2 * iy + 1];
  Rows rl = iso::global_rows(g, jl), rr = iso::global_rows(g, jr);  // the left and right source's rows
  if (staged) {
    int kl = 0, kr = 0;
    for (int k = 0; k < s_cnt; ++k) {
      if (s_src[k] == jl) kl = k;
      if (s_src[k] == jr) kr = k;
    }
    rl = staged_rows(s_dyn, g, kl);
    rr = staged_rows(s_dyn, g, kr);
  }

  // G = 32: a cell's slots are contiguous; else cells interleave in the
  // slots, so a group's reads of slot j are one row; or (the wide build at
  // G < 32) they are the lane's own
  int l_mx[SH ? 1 : CAP], l_mn[SH ? 1 : CAP + 1];
  constexpr int pitch = G == 32 || !SH ? 1 : PTS;
  int* mx = !SH ? l_mx : G == 32 ? s_mx + pt * CAP : s_mx + pt;
  int* mn = !SH ? l_mn : G == 32 ? s_mn + pt * (CAP + 1) : s_mn + pt;
  // the cell's x_m (XM): after the staged rows; G = 32 contiguous, else
  // interleaved by cell
  double* xm = s_dyn + (staged ? g.staged * source_doubles(g) : 0) + (G == 32 ? (size_t)pt * g.N : (size_t)pt);
  constexpr int xpitch = G == 32 ? 1 : PTS;
  const tail::Group<G> grp = tail::group_of<G>(threadIdx.x);
  iso::cell<G, CAP, NC, XM>(g, b, iy, ix, jl, jr, rl, rr, grp, mx, mn, pitch, xm, xpitch);
}

// One launch with `dyn` bytes of dynamic shared memory, opting in above
// the 48 KB a block gets without it; a refused opt-in is returned (and
// cleared from the runtime's last error, so a later launch does not
// report it).
template <int G, int CAP, bool XM>
cudaError_t launch_with(const Args& g, size_t dyn, cudaStream_t stream) {
  if (dyn > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(iso_grid_kernel<G, CAP, XM>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
    if (e != cudaSuccess) {
      cudaGetLastError();
      return e;
    }
  }
  constexpr int PTS = THREADS / G;
  const long long B = (long long)g.NX * g.NY;
  const unsigned blocks = (unsigned)((B + PTS - 1) / PTS);
  iso_grid_kernel<G, CAP, XM><<<blocks, THREADS, dyn, stream>>>(g);
  return cudaGetLastError();
}

// force_xm: -1 the library's choice (xm_bytes), 0 x_m formed on read, 1
// the area whatever its size (tests: past SMEM_OPTIN the opt-in fails
// and the error comes back).
template <int G, int CAP>
cudaError_t launch(Args g, int force_xm, cudaStream_t stream) {
  g.staged = G < 32 ? staged_sources<G, CAP>(g) : 0;
  const size_t rows = g.staged * source_doubles(g) * sizeof(double);
  if constexpr (CAP > tail::SMALL) {
    const size_t xm = force_xm < 0 ? xm_bytes<G, CAP>(g, g.staged) : force_xm ? xm_area<G>(g) : 0;
    if (xm) return launch_with<G, CAP, true>(g, rows + xm, stream);
  } else if (force_xm > 0) {
    return cudaErrorInvalidValue;  // the first build has no x_m area
  }
  return launch_with<G, CAP, false>(g, rows, stream);
}

template <int CAP>
cudaError_t launch_g(int G, const Args& g, int force_xm, cudaStream_t stream) {
  switch (G) {
    case 1: return launch<1, CAP>(g, force_xm, stream);
    case 32: return launch<32, CAP>(g, force_xm, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

int iso_grid_max_phases() { return tail::WIDE; }

const char* iso_grid_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// Sources a block of the build of `cap` phase slots stages in shared
// memory at G lanes per cell for this grid (0: the rows stay in global
// memory), as the launch decides.
int iso_grid_staged_sources(int G, int cap, int W, int NX, int NY, int N, int R, int KG) {
  return iso::staged_sources(G, cap, iso::grid_args(W, NX, NY, N, R, KG));
}

// Bytes of the x_m area a block of the build of `cap` phase slots
// reserves at G lanes per cell for this grid, beside its staged rows (0:
// x_m is formed on read), as the launch decides.
int iso_grid_xm_bytes(int G, int cap, int W, int NX, int NY, int N, int R, int KG) {
  return iso::xm_bytes(G, cap, iso::grid_args(W, NX, NY, N, R, KG));
}

// Static shared bytes a block of the build at G lanes per cell with `cap`
// phase slots reserves: its index slots and, at G < 32, the staged-source list.
int iso_grid_static_smem(int G, int cap) { return iso::static_bytes(G, cap); }

// Launches the kernel's build of `cap` phase slots at G lanes per cell on
// `stream` and returns the launch's error (0 on success;
// cudaErrorInvalidValue for a build the library does not have: G 1 and 32,
// launch.LANES; cap 8 and 64, launch.CAPACITIES; or an x_m area
// forced on the first build; a refused shared-memory opt-in) on `device`,
// and leaves the thread's current device as it found it.  force_xm: -1 the
// library's layout, 0 or 1 the x_m area off or on (tests).  Does not
// synchronise.  All pointers are device pointers; the caller has checked
// shapes, dtypes and bounds (nspec 2: R = 2 or 5 x-rows and KG = 3 or 6
// key-row groups at order 1 or 2).
int iso_grid_launch(int device, void* stream, int G, int cap, int force_xm, const double* lnpi, const double* op,
                    const double* xrows, const double* krows, const double* a, const unsigned char* edge, const double* mu,
                    const int* lr, const double* wts, const double* tg, const double* volume, int W, int NX, int NY, int N,
                    int R, int KG, int P, int smooth, int order, int janus, double cutoff, double* z, double* rho,
                    double* fe, unsigned char* ok, int* code) {
  const fhmc::DeviceGuard on(device);  // the caller's current device is back on every return
  if (on.status() != cudaSuccess) return (int)on.status();
  const long long B = (long long)NX * NY;
  if (B <= 0) return 0;
  const Args g{lnpi, op, xrows, krows, a, edge, mu, lr, wts, tg, volume, W, NX, NY, N, R, KG, P, smooth, order, janus,
               cutoff, 0, z, rho, fe, ok, code};
  const cudaStream_t st = (cudaStream_t)stream;
  switch (cap) {
    case tail::SMALL: return (int)launch_g<tail::SMALL>(G, g, force_xm, st);
    case tail::WIDE: return (int)launch_g<tail::WIDE>(G, g, force_xm, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
