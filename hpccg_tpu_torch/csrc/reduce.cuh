// Shared helpers of the hand-written Hopper kernels (hpccg_tpu_torch/csrc).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace hpccg {

// Sum of one value per thread over a block of NT threads (NT a power of
// two), in a fixed tree order: the same inputs give the same bits on every
// run. No float atomics anywhere in these kernels, for the same reason.
// `red` is NT elements of shared memory; every thread gets the total.
template <typename T, int NT>
__device__ __forceinline__ T block_sum(T v, T* red, int tid) {
  red[tid] = v;
  __syncthreads();
#pragma unroll
  for (int s = NT / 2; s > 0; s >>= 1) {
    if (tid < s) red[tid] += red[tid + s];
    __syncthreads();
  }
  return red[0];
}

// A product and a sum each rounded on its own, never contracted into an FMA:
// the DIA sums (dia.cu, collective_dia.cu) take the roundings of their plain
// torch version (one sliced multiply-add per diagonal) and match it bit for
// bit.
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

}  // namespace hpccg
