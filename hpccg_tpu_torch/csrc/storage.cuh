// Storage and compute types of the hand-written kernels.
//
// A vector is stored in T and computed in S: S is T for float and double,
// float for __nv_bfloat16. Loads upcast with to_s; stores round with
// from_s<T> (__float2bfloat16: round to nearest even, as torch's
// .to(torch.bfloat16)). For float and double both are the identity.
#pragma once

#include <cuda_bf16.h>

namespace hpccg {

__device__ __forceinline__ float to_s(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_s(float v) { return v; }
__device__ __forceinline__ double to_s(double v) { return v; }

template <typename T, typename S>
__device__ __forceinline__ T from_s(S v) {
  return T(v);
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_s<__nv_bfloat16, float>(float v) {
  return __float2bfloat16(v);
}

}  // namespace hpccg
