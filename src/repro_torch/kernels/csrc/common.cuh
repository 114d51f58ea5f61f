// Shared helpers of the Nekbone kernels (nekbone_ax.cu, nekbone_ax_slab.cu,
// nekbone_cg_update.cu).
//
// * Rounded arithmetic without contraction.  The CG vector updates
//   (p = r + beta p, x += alpha p, r -= alpha w) use explicitly rounded
//   multiply and add, so nvcc does not fuse them into an FMA: the stored
//   vectors are then bitwise what the plain PyTorch versions compute (one
//   rounding per operation, as separate tensor ops do).  The tensor
//   contractions are free to use FMA.
// * A deterministic block sum: a fixed shared-memory tree, so partial inner
//   products are the same from run to run (no atomics).
// * Dispatch of the run-time n (2..16) to the template instantiations.
#pragma once

#include <cuda_runtime.h>

namespace nekbone {

__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }

__host__ __device__ constexpr int pow2_ceil(int v) {
  int p = 1;
  while (p < v) p <<= 1;
  return p;
}

// Sum of one value per thread over the block's NT threads (tid < NT); the
// result is valid in thread 0.  `sh` holds at least NT values.
template <int NT, typename T>
__device__ __forceinline__ T block_sum(T v, T* sh, int tid) {
  sh[tid] = v;
  __syncthreads();
  constexpr int kHalf = pow2_ceil(NT) / 2;
#pragma unroll
  for (int s = kHalf; s > 0; s >>= 1) {
    if (tid < s && tid + s < NT) sh[tid] += sh[tid + s];
    __syncthreads();
  }
  return sh[0];
}

}  // namespace nekbone

// Expands CASE(N) for every supported n; used inside a switch on n.
#define NEKBONE_FOR_EACH_N(CASE) \
  CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8) CASE(9) \
  CASE(10) CASE(11) CASE(12) CASE(13) CASE(14) CASE(15) CASE(16)
