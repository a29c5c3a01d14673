// HBM bandwidth probe kernels for Hopper (sm_90a).
//
// Replace the TPU probes
//   exp/stream_probe.py:make_pallas_copy (copy_kernel: y = x + 1, the rate
//     of a copy that streams one read and one write)
//   exp/rw_probe.py:write_big (wkernel: o = tile(seed) * 1.00001, the rate
//     of writes alone: the small seed block is read again and again)
// utils/bandwidth.py times them; the benchmark's vs_baseline divides by the
// copy rate that they measure on this card.
//
// What bounds them: memory bandwidth and nothing else (one add or one
// multiply per 4 bytes). The arrays must be far larger than the 50 MB L2, or
// the probe measures the L2: utils/bandwidth.py takes 1 GiB each. The
// (512, 128) float32 seed of the write probe (256 KB) stays in L2, so only
// the writes stream, as in the JAX probe.
//
// What the design does about it: 16-byte loads and stores, neighbouring
// threads on neighbouring addresses. The copy takes one float4 per thread
// and one block of 128 threads per 128 float4 (no grid stride, as torch's
// vectorized elementwise kernels): on an H100 it ran 1-2% under torch.add,
// where a grid-stride loop with four float4 in flight per thread ran 7-9%
// under it, and streaming cache hints (__ldcs/__stcs) slower still
// (scripts/copy_probe_variants.py, PERF.md). The write probe is a
// grid-stride loop, 8 blocks of 256 threads per SM, that walks the seed
// with an index advanced by the grid's stride (no 64-bit modulo per
// element). The scalar tails past the last whole float4 are done by the
// first block. float32 only, 16-byte aligned pointers (torch's allocations
// are).
// Simple first: no TMA bulk copies.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;       // write probe: threads per block
constexpr int COPY_NT = 128;  // copy probe: threads (float4) per block
constexpr float SCALE = 1.00001f;  // rw_probe.py:17

__global__ void __launch_bounds__(COPY_NT)
    copy_kernel(const float* __restrict__ x, float* __restrict__ y, int64_t n) {
  const int64_t n4 = n / 4;
  const int64_t i = (int64_t)blockIdx.x * COPY_NT + threadIdx.x;
  if (i < n4) {
    float4 v = reinterpret_cast<const float4*>(x)[i];
    v.x += 1.0f;
    v.y += 1.0f;
    v.z += 1.0f;
    v.w += 1.0f;
    reinterpret_cast<float4*>(y)[i] = v;
  }
  if (blockIdx.x == 0) {
    for (int64_t t = 4 * n4 + threadIdx.x; t < n; t += COPY_NT) y[t] = x[t] + 1.0f;
  }
}

// o[i] = seed[i mod m] * SCALE; m is a multiple of 4, so float4 i of o is
// float4 (i mod m/4) of the seed.
__global__ void __launch_bounds__(NT)
    write_kernel(const float* __restrict__ seed, int64_t m, float* __restrict__ o, int64_t n) {
  const float4* __restrict__ s4 = reinterpret_cast<const float4*>(seed);
  float4* __restrict__ o4 = reinterpret_cast<float4*>(o);
  const int64_t n4 = n / 4, m4 = m / 4;
  const int64_t stride = (int64_t)gridDim.x * NT;
  const int64_t step = stride % m4;
  int64_t i = (int64_t)blockIdx.x * NT + threadIdx.x;
  int64_t j = i % m4;
  for (; i < n4; i += stride) {
    float4 v = __ldg(s4 + j);
    v.x *= SCALE;
    v.y *= SCALE;
    v.z *= SCALE;
    v.w *= SCALE;
    o4[i] = v;
    j += step;
    if (j >= m4) j -= m4;
  }
  if (blockIdx.x == 0) {
    for (int64_t t = 4 * n4 + threadIdx.x; t < n; t += NT) o[t] = seed[t % m] * SCALE;
  }
}

int probe_blocks(int64_t work, int* blocks) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int64_t want = (work + NT - 1) / NT;
  const int64_t cap = (int64_t)sms * 8;
  *blocks = (int)(want < 1 ? 1 : (want < cap ? want : cap));
  return (int)cudaSuccess;
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

}  // namespace

extern "C" {

// y = x + 1 over n float32 elements.
int hpccg_stream_copy_f32(const float* x, float* y, long long n, void* stream) {
  if (n < 1 || !aligned16(x) || !aligned16(y)) return (int)cudaErrorInvalidValue;
  const long long blocks = (n / 4 + COPY_NT - 1) / COPY_NT;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  copy_kernel<<<(unsigned)(blocks < 1 ? 1 : blocks), COPY_NT, 0, (cudaStream_t)stream>>>(x, y, n);
  return (int)cudaGetLastError();
}

// o[i] = seed[i mod m] * 1.00001 over n float32 elements; m a multiple of 4.
int hpccg_stream_write_f32(const float* seed, long long m, float* o, long long n, void* stream) {
  if (n < 1 || m < 4 || m % 4 != 0 || !aligned16(seed) || !aligned16(o)) {
    return (int)cudaErrorInvalidValue;
  }
  int blocks = 0;
  const int err = probe_blocks(n / 4, &blocks);
  if (err != (int)cudaSuccess) return err;
  write_kernel<<<blocks, NT, 0, (cudaStream_t)stream>>>(seed, m, o, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
