// K2's x' area rule: where a block of kernel K2 (mb_sweep_thermo.cu)
// forms each point's x' once a bin into shared memory, and the shared
// bytes that build reserves.
//
// Shared by csrc/mb_sweep_thermo.cu (the kernel, its launch and its
// exports mb_sweep_thermo_xarea_fits / _static_smem) and tests/tail_host/
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

// Static shared bytes of a block of K2's build at G lanes a point with
// `cap` phase slots, with the x' area (xa) or without: the area's build
// its own block of XA_THREADS points, the others the index slots and row
// tile of a block of tail::THREADS threads, as K1's.
inline int static_bytes(int G, int cap, bool xa) {
  if (!xa) return tail::block_static_bytes(G, cap);
  switch (cap) {
    case tail::SMALL: return (int)xa_static_bytes<tail::SMALL>();
    case tail::WIDE: return (int)xa_static_bytes<tail::WIDE>();
    default: return 0;
  }
}

}  // namespace mbxa
