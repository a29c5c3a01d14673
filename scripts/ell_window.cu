// ELL SpMV by column windows in shared memory, for scripts/ell_window.py:
// the bucketed form of the JAX package's strip and window tiers
// (hpccg_tpu/ops/pallas/gell_stack.py, gell_dynwin.py) on Hopper (sm_90a),
// timed against the ELL kernel (csrc/ell.cu) on a random wide scatter.
//
// x is cut into windows of W elements. ell_window.py buckets the valid
// slots by window; a segment is one row's slots in one window. Each block
// owns a chunk of one window's segments: it stages that window of x into its
// shared memory (x[w * W, (w + 1) * W), coalesced 16-byte loads), then each
// thread sums one segment's slots in slot order from shared memory and
// writes the partial sum to part[ppos[segment]] (row order: scattered
// stores), or, in the coalesced variant, to part[q] at its own position q
// in the window-major layout (coalesced stores). The segments of a window
// are sorted by length (longest first) and padded to groups of 32, one
// group a warp, stored slot-major within the group (entry gofs[g] + t * 32 +
// lane), so a warp's value and column reads coalesce and its padding stays
// near its longest segment. Columns are 16-bit offsets into the window.
// A second kernel sums each row's partials in window order:
// y[i] = sum_{k in [rowptr[i], rowptr[i + 1])} part[k] (ppos puts a row's
// partials there), or part[qpos[k]] in the coalesced variant (scattered
// loads). No atomics: two launches are bit-identical.
//
// Dummy lanes of a padded group add zeros and write a slot no row reads
// (part[nseg] in row order, their own position in the coalesced variant).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

template <typename T>
__device__ __forceinline__ T ld_stream(const T* p) {
  return __ldcs(p);
}

template <typename T>
__global__ void window_kernel(const T* __restrict__ vals, const unsigned short* __restrict__ lcol,
                              const long long* __restrict__ gofs, const int* __restrict__ chunk_win,
                              const int* __restrict__ chunk_g, const int* __restrict__ ppos, const T* __restrict__ x,
                              long long n, int W, bool coalesced, T* __restrict__ part) {
  extern __shared__ uint4 smem[];
  T* xs = reinterpret_cast<T*>(smem);
  const int c = blockIdx.x;
  const long long base = (long long)chunk_win[c] * W;
  const long long len = n - base < W ? n - base : W;
  // stage the window: 16-byte loads, then the tail element by element
  const long long vec = len * (long long)sizeof(T) / 16;
  const uint4* src = reinterpret_cast<const uint4*>(x + base);
  for (long long j = threadIdx.x; j < vec; j += blockDim.x) smem[j] = __ldg(src + j);
  for (long long j = vec * 16 / sizeof(T) + threadIdx.x; j < len; j += blockDim.x) xs[j] = __ldg(x + base + j);
  __syncthreads();
  const int warps = blockDim.x / 32, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int g = chunk_g[c] + warp; g < chunk_g[c + 1]; g += warps) {
    const long long e0 = gofs[g];
    const int width = (int)((gofs[g + 1] - e0) / 32);
    T acc = T(0);
    int t = 0;
    for (; t + 4 <= width; t += 4) {
      T v[4];
      unsigned short k[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        v[u] = ld_stream(vals + e0 + (t + u) * 32 + lane);
        k[u] = ld_stream(lcol + e0 + (t + u) * 32 + lane);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) acc += v[u] * xs[k[u]];
    }
    for (; t < width; ++t) acc += ld_stream(vals + e0 + t * 32 + lane) * xs[ld_stream(lcol + e0 + t * 32 + lane)];
    const long long q = (long long)g * 32 + lane;
    part[coalesced ? q : ld_stream(ppos + q)] = acc;
  }
}

template <typename T>
__global__ void combine_kernel(const int* __restrict__ rowptr, const int* __restrict__ qpos, const T* __restrict__ part,
                               T* __restrict__ y, long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    T acc = T(0);
    for (int k = __ldg(rowptr + i); k < __ldg(rowptr + i + 1); ++k) acc += __ldcg(part + (qpos ? __ldg(qpos + k) : k));
    y[i] = acc;
  }
}

template <typename T>
int run(const T* vals, const unsigned short* lcol, const long long* gofs, const int* chunk_win, const int* chunk_g,
        int nchunks, const int* ppos, const int* qpos, const int* rowptr, const T* x, long long n, int W, int threads,
        T* part, T* y, int which, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int smem = W * (int)sizeof(T);
  if (which & 1) {
    cudaError_t err = cudaFuncSetAttribute(window_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    window_kernel<T><<<nchunks, threads, smem, s>>>(vals, lcol, gofs, chunk_win, chunk_g, ppos, x, n, W,
                                                    qpos != nullptr, part);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (which & 2) {
    long long blocks = (n + 255) / 256;
    if (blocks > 65536) blocks = 65536;
    combine_kernel<T><<<(unsigned)blocks, 256, 0, s>>>(rowptr, qpos, part, y, n);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// which: 1 the window kernel, 2 the combine kernel, 3 both. qpos null:
// partials stored in row order (part[ppos[q]]); else the coalesced variant.
int ell_window_f32(const float* vals, const unsigned short* lcol, const long long* gofs, const int* chunk_win,
                   const int* chunk_g, int nchunks, const int* ppos, const int* qpos, const int* rowptr,
                   const float* x, long long n, int W, int threads, float* part, float* y, int which, void* stream) {
  return run<float>(vals, lcol, gofs, chunk_win, chunk_g, nchunks, ppos, qpos, rowptr, x, n, W, threads, part, y,
                    which, stream);
}

int ell_window_f64(const double* vals, const unsigned short* lcol, const long long* gofs, const int* chunk_win,
                   const int* chunk_g, int nchunks, const int* ppos, const int* qpos, const int* rowptr,
                   const double* x, long long n, int W, int threads, double* part, double* y, int which,
                   void* stream) {
  return run<double>(vals, lcol, gofs, chunk_win, chunk_g, nchunks, ppos, qpos, rowptr, x, n, W, threads, part, y,
                     which, stream);
}

}  // extern "C"
