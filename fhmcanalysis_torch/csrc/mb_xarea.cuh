// K2's x' area rule: where a block of kernel K2 (mb_sweep_thermo.cu)
// forms each point's x' once a bin into shared memory, and the shared
// bytes that build reserves; and the target tile's rule: where a block of
// that build holds TILE_T targets x TILE_M mu values and forms its
// targets' key' once into shared memory.
//
// Shared by csrc/mb_sweep_thermo.cu (the kernel, its launch and its
// exports mb_sweep_thermo_xarea_fits / _tile_fits / _static_smem) and tests/tail_host/
// (the same rule built with g++, which the CPU tests hold to their
// numbers), so the rule is written once.

#pragma once

#include "thermo_tail.cuh"

namespace mbxa {

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
__host__ __device__ constexpr int block_threads() { return XA ? XA_THREADS : tail::THREADS; }

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
// N = 40-47, the area ran no faster than forming x' on read: PERF.md).
template <int CAP>
__host__ __device__ __forceinline__ bool xarea_fits(int G, int N) {
  if (G != 1) return false;
  const size_t rows = (size_t)XA_ROWS * N * sizeof(double);
  const size_t block = xarea_bytes<1>(N) + rows + xa_static_bytes<CAP>() + SMEM_RESERVED;
  return XA_MIN_BLOCKS * block <= SMEM_SM;
}

// The rule for the build of `cap` phase slots named at run time (0 for a
// build the library does not have).
inline int xarea_fits(int G, int cap, int N) {
  switch (cap) {
    case tail::SMALL: return xarea_fits<tail::SMALL>(G, N);
    case tail::WIDE: return xarea_fits<tail::WIDE>(G, N);
    default: return 0;
  }
}

// The target tile.  key'_k(i) depends on the target and the bin, never on
// mu, yet the tail reads it at every covered bin of every point.  A block
// of the area's build in the product mode holds XA_THREADS consecutive
// points, one mu and up to 64 targets, whose key' rows would not fit; a
// tiled block holds TILE_T targets x TILE_M mu values instead (lane pt:
// target t0 + pt % TILE_T, mu m0 + pt / TILE_T; blocks take target groups
// fastest, then mu chunks; a point's output row stays b = m A + t), and
// forms its targets' key' once into a table of shared memory,
// [TILE_T][S+1][N], which the tail reads.  At TILE_T = 8 a warp's 32 points
// are 8 consecutive rows of 4 mu values, so a store of a float field
// touches as many 128-byte lines as 32 consecutive rows do.  The block
// stages lnpi, op and the x-rows beside the table (TILE_ROWS at most) and
// the key rows only until the table is formed, in the bytes of the x'
// area, which is written after it.
constexpr int TILE_T = 8;
constexpr int TILE_M = XA_THREADS / TILE_T;
constexpr int TILE_ROWS = 7;  // lnpi, op, 5 x-rows (nspec 2, order 2)
constexpr int TILE_KEYS = 3;  // key rows a target: S + 1 at nspec 2
static_assert(XA_THREADS % TILE_T == 0, "a tiled block holds whole target groups");
static_assert(XA_ROWS - TILE_ROWS <= XA_THREADS, "the key rows are staged in the bytes of the x' area");

// Bytes of a tiled block's key' table at S species (with props).
__host__ __device__ __forceinline__ size_t tile_table_bytes(int S, int N) { return (size_t)TILE_T * (S + 1) * N * sizeof(double); }

// Target groups of a tiled launch over A targets (its blocks: groups x mu chunks).
__host__ __device__ __forceinline__ long long tile_groups(long long A) { return (A + TILE_T - 1) / TILE_T; }
__host__ __device__ __forceinline__ long long tile_blocks(long long M, long long A) { return tile_groups(A) * ((M + TILE_M - 1) / TILE_M); }

// The shared bytes the rule counts for a tiled block: its x' area, the
// most rows it stages and the largest table, its static slots and the
// runtime's reserve.
template <int CAP>
__host__ __device__ __forceinline__ size_t tile_block_bytes(int N) {
  return xarea_bytes<1>(N) + (size_t)(TILE_ROWS + TILE_T * TILE_KEYS) * N * sizeof(double) + xa_static_bytes<CAP>() + SMEM_RESERVED;
}

// Whether a launch of M mu values x A targets takes the tile: the product
// mode (the paired mode's points are the solver's, one target each) at
// G = 1 in the build of 8 slots, where the area's rule holds, the tiled
// block keeps the XA_MIN_BLOCKS blocks an SM, and the lanes the tile pads
// (a partial target group or mu chunk) are at most an eighth of the launch's.
template <int CAP>
__host__ __device__ __forceinline__ bool tile_fits(int G, bool paired, int N, long long M, long long A) {
  if (CAP != tail::SMALL || paired || M <= 0 || A <= 0 || !xarea_fits<CAP>(G, N)) return false;
  if (XA_MIN_BLOCKS * tile_block_bytes<CAP>(N) > SMEM_SM) return false;
  const long long lanes = tile_blocks(M, A) * XA_THREADS;
  return 8 * (lanes - M * A) <= lanes;
}

// The tile's rule for the build of `cap` phase slots named at run time.
inline int tile_fits(int G, int cap, bool paired, int N, long long M, long long A) {
  return cap == tail::SMALL && tile_fits<tail::SMALL>(G, paired, N, M, A);
}

// Static shared bytes of a block of K2's build at G lanes a point with
// `cap` phase slots, with the x' area (xa) or without: the area's build
// (tiled or not) its own block of XA_THREADS points, the others the index
// slots and row tile of a block of tail::THREADS threads, as K1's.
inline int static_bytes(int G, int cap, bool xa) {
  if (!xa) return tail::block_static_bytes(G, cap);
  switch (cap) {
    case tail::SMALL: return (int)xa_static_bytes<tail::SMALL>();
    case tail::WIDE: return (int)xa_static_bytes<tail::WIDE>();
    default: return 0;
  }
}

}  // namespace mbxa
