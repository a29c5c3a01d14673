// Probe of random 4- and 8-byte gathers on Hopper (sm_90a), for
// scripts/scatter_probe.py: how fast can x[cols[k]] be served, for a
// given column pattern, from global memory (through L1/L2), from one
// block's shared memory, and from the shared memory of the blocks of a
// thread-block cluster (distributed shared memory)?
//
// Every mode streams the same int32 columns, slot-major (width, n), one
// thread a row, and sums what it gathers into y[row]:
//   0  the columns alone (the column stream's floor),
//   1  x[col] through __ldg (L1/L2), as the ELL kernel gathers today,
//   2  x[col & (W - 1)] from the block's shared memory, x cut to W,
//   3  the cluster's shared memory: W elements a block, C blocks, x cut to
//      C * W; element j lives in block j >> log2(W) at j & (W - 1), read
//      with mapa + ld.shared::cluster,
//   4  mode 3's staging and cluster barriers alone,
//   5  mode 1 with the columns read as a stream (__ldcs: evict first), so
//      that L1 keeps x's lines.
// The distributed loads carry no memory clobber: the cluster barrier
// before them orders them after the staging, and a clobber would keep the
// compiler from issuing the next slot's column load before this load.
// Modes 2-4 stage their part of x with plain loads first. One block a SM
// (1024 threads) in modes 2-4, a persistent grid of the resident clusters
// in 3-4; modes 0-1 take `blocks_per_sm` blocks a SM.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int NT = 1024;

__device__ __forceinline__ uint32_t mapa(uint32_t addr, uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

__device__ __forceinline__ float ld_cluster(const float*, uint32_t addr) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];" : "=f"(v) : "r"(addr));
  return v;
}

__device__ __forceinline__ double ld_cluster(const double*, uint32_t addr) {
  double v;
  asm volatile("ld.shared::cluster.f64 %0, [%1];" : "=d"(v) : "r"(addr));
  return v;
}

template <typename T, int MODE>
__global__ void __launch_bounds__(NT) probe_kernel(const int* __restrict__ cols, int width, long long n,
                                                   const T* __restrict__ x, int wshift, int cshift,
                                                   T* __restrict__ y) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sx = reinterpret_cast<T*>(smem_raw);
  const int W = 1 << wshift;
  unsigned rank = 0;
  if constexpr (MODE == 3 || MODE == 4) rank = cg::this_cluster().block_rank();
  if constexpr (MODE >= 2 && MODE <= 4) {
    for (int i = threadIdx.x; i < W; i += NT) sx[i] = x[((long long)rank << wshift) + i];
    if constexpr (MODE >= 3) {
      cg::this_cluster().sync();
    } else {
      __syncthreads();
    }
  }
  const uint32_t base = (uint32_t)__cvta_generic_to_shared(sx);
  const long long per = (n + gridDim.x - 1) / gridDim.x;
  const long long r0 = (long long)blockIdx.x * per;
  const long long r1 = r0 + per < n ? r0 + per : n;
  if constexpr (MODE != 4) {
    for (long long row = r0 + threadIdx.x; row < r1; row += NT) {
      T acc = T(0);
#pragma unroll 4
      for (int s = 0; s < width; ++s) {
        const int c = MODE == 5 ? __ldcs(cols + (long long)s * n + row) : cols[(long long)s * n + row];
        if constexpr (MODE == 0 || MODE == 4) {
          acc += T(c);
        } else if constexpr (MODE == 1 || MODE == 5) {
          acc += __ldg(x + c);
        } else if constexpr (MODE == 2) {
          acc += sx[c & (W - 1)];
        } else {
          const unsigned lc = (unsigned)c & ((1u << (wshift + cshift)) - 1u);
          acc += ld_cluster(sx, mapa(base + (lc & (W - 1)) * (unsigned)sizeof(T), lc >> wshift));
        }
      }
      y[row] = acc;
    }
  }
  if constexpr (MODE == 3 || MODE == 4) cg::this_cluster().sync();  // no block leaves while others read its memory
}

template <typename T, int MODE>
int run(int csize, int blocks_per_sm, const int* cols, int width, long long n, const T* x, int wshift, int cshift,
        T* y, int reps, float* ms, int* clusters) {
  auto kern = probe_kernel<T, MODE>;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const size_t smem = MODE >= 2 && MODE <= 4 ? ((size_t)sizeof(T) << wshift) : 0;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = 0;
  if (MODE == 3 || MODE == 4) {
    if (csize > 8) {
      err = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (err != cudaSuccess) return (int)err;
    }
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = csize;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    cfg.gridDim = dim3(csize);
    int active = 0;
    err = cudaOccupancyMaxActiveClusters(&active, (void*)kern, &cfg);
    if (err != cudaSuccess) return (int)err;
    if (active < 1) return (int)cudaErrorInvalidConfiguration;
    *clusters = active;
    cfg.gridDim = dim3(active * csize);
  } else {
    *clusters = 0;
    cfg.gridDim = dim3(sms * (MODE == 2 ? 1 : blocks_per_sm));
  }
  for (int i = 0; i < 2; ++i) {
    err = cudaLaunchKernelEx(&cfg, kern, cols, width, n, x, wshift, cshift, y);
    if (err != cudaSuccess) return (int)err;
  }
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  cudaEventRecord(a, 0);
  for (int i = 0; i < reps; ++i) cudaLaunchKernelEx(&cfg, kern, cols, width, n, x, wshift, cshift, y);
  cudaEventRecord(b, 0);
  err = cudaEventSynchronize(b);
  float total = 0.f;
  cudaEventElapsedTime(&total, a, b);
  cudaEventDestroy(a);
  cudaEventDestroy(b);
  *ms = total / reps;
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int mode, int csize, int blocks_per_sm, const int* cols, int width, long long n, const void* x,
             int wshift, int cshift, void* y, int reps, float* ms, int* clusters) {
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  switch (mode) {
    case 0: return run<T, 0>(csize, blocks_per_sm, cols, width, n, xt, wshift, cshift, yt, reps, ms, clusters);
    case 1: return run<T, 1>(csize, blocks_per_sm, cols, width, n, xt, wshift, cshift, yt, reps, ms, clusters);
    case 2: return run<T, 2>(csize, blocks_per_sm, cols, width, n, xt, wshift, cshift, yt, reps, ms, clusters);
    case 3: return run<T, 3>(csize, blocks_per_sm, cols, width, n, xt, wshift, cshift, yt, reps, ms, clusters);
    case 4: return run<T, 4>(csize, blocks_per_sm, cols, width, n, xt, wshift, cshift, yt, reps, ms, clusters);
    case 5: return run<T, 5>(csize, blocks_per_sm, cols, width, n, xt, wshift, cshift, yt, reps, ms, clusters);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int scatter_probe(int elsize, int mode, int csize, int blocks_per_sm, const int* cols, int width,
                             long long n, const void* x, int wshift, int cshift, void* y, int reps, float* ms,
                             int* clusters) {
  if (elsize == 4) return dispatch<float>(mode, csize, blocks_per_sm, cols, width, n, x, wshift, cshift, y, reps,
                                          ms, clusters);
  if (elsize == 8) return dispatch<double>(mode, csize, blocks_per_sm, cols, width, n, x, wshift, cshift, y, reps,
                                           ms, clusters);
  return (int)cudaErrorInvalidValue;
}
