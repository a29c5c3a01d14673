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

// Loads through L2 only (ld.global.cg), never from a possibly stale L1
// line: for data that other blocks wrote earlier in the same launch.
__device__ __forceinline__ float ldcg(const float* p) { return __ldcg(p); }
__device__ __forceinline__ double ldcg(const double* p) { return __ldcg(p); }
__device__ __forceinline__ uint4 ldcg(const uint4* p) { return __ldcg(p); }
__device__ __forceinline__ __nv_bfloat16 ldcg(const __nv_bfloat16* p) {
  return __ushort_as_bfloat16(__ldcg(reinterpret_cast<const unsigned short*>(p)));
}

}  // namespace hpccg
