// ELL gather SpMV for Hopper (sm_90a): K11 (float, and its bfloat16-storage
// instance) and K12 (double), which also computes what K14 computes, and
// what K13 computes on a matrix it is not given relabelled
// (csrc/ell_scatter.cu).
//
// Replaces hpccg_tpu/ops/pallas/gell_kernel.py:_kernel (K11) and :_kernel_dd
// (K12), and the dynamic-window tier gell_dynwin.py:_kernel_dynwin(_dd)
// (K14). The TPU has no hardware gather: its kernels scan 128-lane chunks of
// an x window per 1024-row tile (K11) or give each (tile, slot) its own
// window base (K14), and carry f64 as (hi, lo) f32 pairs. Hopper gathers
// natively and has f64, so one kernel computes
// y[i] = sum_s vals[s, i] * x[cols[s, i]] for every class of matrix, and
// the f64 tiers are its double instance.
//
// What bounds it on the card: memory bandwidth. It streams every padded
// slot, width*n*(s + 4) bytes of values and int32 columns, plus the x it
// gathers and y: width*n*(s+4) + 2n*s per SpMV, the x reads served from L2
// as far as the column pattern keeps them near each other. On a scattered
// matrix (K14's random band) a 4-byte gather costs a 32-byte L2 sector and
// the lanes of a warp share none: the L2's scattered-gather rate binds
// (scripts/scatter_probe.py, PERF.md). What the design does about it: the
// matrix is slot-major ((width, n), built once per matrix by prepare_ell),
// so a warp's value and column reads coalesce; they are read once, as
// evict-first streams (ld.global.cs), so that L1 and L2 keep x; each thread
// has U slots in flight (their values and columns, then their gathers);
// one thread per row in a grid-stride loop with 64-bit indexing; x is read
// through the read-only path (__ldg). Invalid slots hold val 0 and col 0
// and add 0 * x[0], as the JAX package's take + einsum does. Skewed row
// lengths stream every padded slot; sliced ELL or CSR would not (later
// work).
//
// The sum runs in slot order, in S. No atomics: two launches are
// bit-identical.
//
// bfloat16 (T = __nv_bfloat16, S = float; storage.cuh): values, x and y in
// bf16, int32 columns, the sum in f32 and y rounded once. A product of two
// bf16 values is exact in f32, so a contracted FMA gives the bits of a
// product and a sum rounded apart: the plain version's slot-order f32 sum
// matches bit for bit. Bytes per SpMV: width*n*(2 + 4) + 2n*2. The JAX
// package's chooser never builds its K11 for 2-byte values
// (hpccg_tpu/reorder.py:257-259); its bf16 ELL matvec is XLA's.

#include "storage.cuh"

// Split builds for scripts/ell_scatter_sweep.py (0 in the library): 1 reads
// x[row] in place of x[cols[k]] (every byte stream unchanged, the gather
// local), 2 streams the columns and gathers, with no value stream.
#ifndef HPCCG_ELL_SPLIT
#define HPCCG_ELL_SPLIT 0
#endif

namespace {

using hpccg::from_s;
using hpccg::to_s;

constexpr int NT = 256;
constexpr long long MAX_BLOCKS = 65536;
// Slots a thread has in flight (8 ran slower on the wide-scatter classes,
// PERF.md).
constexpr int U = 4;

// The values and columns are read once: evict-first (ld.global.cs), so that
// L1 and L2 keep x (__ldg streams ran 3-14% slower on scattered matrices).
__device__ __forceinline__ float ld_stream(const float* p) { return __ldcs(p); }
__device__ __forceinline__ double ld_stream(const double* p) { return __ldcs(p); }
__device__ __forceinline__ int ld_stream(const int* p) { return __ldcs(p); }
__device__ __forceinline__ __nv_bfloat16 ld_stream(const __nv_bfloat16* p) {
  return __ushort_as_bfloat16(__ldcs(reinterpret_cast<const unsigned short*>(p)));
}

// x[col], the gather (the first split build reads x[row])
template <typename T>
__device__ __forceinline__ T gather(const T* __restrict__ x, int col, long long row) {
#if HPCCG_ELL_SPLIT == 1
  return __ldg(x + row + (col < 0));
#else
  return __ldg(x + col);
#endif
}

// the slot's term of the sum (the second split build drops the value)
template <typename T, typename S>
__device__ __forceinline__ void add(S& acc, T v, T g) {
#if HPCCG_ELL_SPLIT == 2
  acc += to_s(g);
#else
  acc += to_s(v) * to_s(g);
#endif
}

template <typename T, typename S>
__global__ void __launch_bounds__(NT)
    ell_spmv_kernel(const T* __restrict__ vals, const int* __restrict__ cols, int width,
                    const T* __restrict__ x, T* __restrict__ y, long long n) {
  const long long stride = (long long)gridDim.x * NT;
  for (long long row = (long long)blockIdx.x * NT + threadIdx.x; row < n; row += stride) {
    S acc = S(0);
    int s = 0;
    for (; s + U <= width; s += U) {
      T v[U];
      int c[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const long long k = (long long)(s + u) * n + row;
        v[u] = ld_stream(vals + k);
        c[u] = ld_stream(cols + k);
      }
      T g[U];
#pragma unroll
      for (int u = 0; u < U; ++u) g[u] = gather(x, c[u], row);
#pragma unroll
      for (int u = 0; u < U; ++u) add<T, S>(acc, v[u], g[u]);
    }
    for (; s < width; ++s) {
      const long long k = (long long)s * n + row;
      add<T, S>(acc, ld_stream(vals + k), gather(x, ld_stream(cols + k), row));
    }
    y[row] = from_s<T>(acc);
  }
}

template <typename T, typename S>
int launch_ell(const T* vals, const int* cols, int width, const T* x, T* y, long long n,
               void* stream) {
  if (n < 1 || width < 0) return (int)cudaErrorInvalidValue;
  long long blocks = (n + NT - 1) / NT;
  if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
  ell_spmv_kernel<T, S><<<(unsigned)blocks, NT, 0, (cudaStream_t)stream>>>(vals, cols, width, x, y, n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// vals: (width, n) slot-major; cols: (width, n) int32 in [0, len(x)).
int hpccg_ell_f32(const float* vals, const int* cols, int width, const float* x, float* y,
                  long long n, void* stream) {
  return launch_ell<float, float>(vals, cols, width, x, y, n, stream);
}

int hpccg_ell_f64(const double* vals, const int* cols, int width, const double* x, double* y,
                  long long n, void* stream) {
  return launch_ell<double, double>(vals, cols, width, x, y, n, stream);
}

int hpccg_ell_bf16(const __nv_bfloat16* vals, const int* cols, int width, const __nv_bfloat16* x,
                   __nv_bfloat16* y, long long n, void* stream) {
  return launch_ell<__nv_bfloat16, float>(vals, cols, width, x, y, n, stream);
}

}  // extern "C"
