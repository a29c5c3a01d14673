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

}  // namespace hpccg
