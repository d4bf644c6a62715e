// A host stand-in for the CUDA runtime header, enough to compile
// fhmcanalysis_torch/csrc/thermo_tail.cuh, iso_cell.cuh, mb_xarea.cuh and
// mb_rows.cuh with g++ for one lane (G = 1, one live lane):
// tests/test_torch_capacity.py runs the tail's bodies, K3's cell and the
// kernels' layout rules on the CPU with it, and tests/test_torch_mb_rows.py
// the row former.  A warp collective of
// one lane returns its own value; the rounded f64 intrinsics are plain
// operations (the library is built with -ffp-contract=off, as the
// kernels with -fmad=false).
#pragma once
#include <algorithm>
#include <cmath>
#include <cstddef>
#include <cstdint>
using std::max;
using std::min;
#define __device__
#define __host__
#define __forceinline__ inline
typedef int cudaError_t;
struct HostThreadIdx {
  unsigned x;
};
static HostThreadIdx threadIdx{0};
inline int __popc(unsigned v) { return __builtin_popcount(v); }
template <typename T>
inline T __shfl_xor_sync(unsigned, T v, int, int = 32) { return v; }
template <typename T>
inline T __shfl_sync(unsigned, T v, int, int = 32) { return v; }
inline unsigned __ballot_sync(unsigned, bool p) { return p ? 1u : 0u; }
inline void __syncwarp(unsigned = 0xffffffffu) {}
template <typename T>
inline T __ldg(const T* p) { return *p; }
inline double __dadd_rn(double a, double b) { return a + b; }
inline double __dsub_rn(double a, double b) { return a - b; }
inline double __dmul_rn(double a, double b) { return a * b; }
inline double __ddiv_rn(double a, double b) { return a / b; }
