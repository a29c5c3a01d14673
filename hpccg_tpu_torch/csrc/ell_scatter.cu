// Wide-scatter ELL gather SpMV for Hopper (sm_90a): K13, float and double.
//
// Replaces hpccg_tpu/ops/pallas/gell_stack.py:_kernel_stack (K13) and
// :_kernel_stack_dd. The TPU has no gather: that tier buckets a row's slots
// into column strips and scans a VMEM-resident x window per strip. Hopper
// gathers natively; what it cannot do cheaply is a scattered one.
//
// What bounds it on the card. The HBM bytes are those of K11 (values and
// int32 columns of every slot, x, y), but a gather of 4 or 8 bytes costs a
// 32-byte L2 sector, and on a scattered matrix the 32 lanes of a warp never
// share one: the randomly permuted 64^3 stencil moves ~220 MB of sectors
// for the 58.7 MB its bound counts. Measured (scripts/scatter_probe.py,
// PERF.md): random gathers from L2 run at 138-168 G/s on the card, from a
// block's own shared memory at 500-770 G/s, and through distributed shared
// memory across a cluster at 63-171 G/s: no faster than L2. So the kernel
// keeps the gathers in L1/L2 and gives them locality instead. The rows of a
// scattered square matrix come in a bandwidth-reducing order (reverse
// Cuthill-McKee, chosen by hpccg_tpu_torch/reorder.py::relabel_order; work
// position i computes row order[i]) and x is relabelled the same way
// (x'[j] = x[order[j]], the columns stored as positions in x'). Each launch
// first builds x' (one scattered read of x per element: ncols sectors, not
// one per slot), then gathers from x' as K11 gathers on a banded matrix: a
// warp's rows are neighbours, their columns share sectors and L1 lines.
// y[order[i]] is written at the end, one scattered 4/8-byte store per row.
// (A random band gains nothing from the relabel: it runs K11, csrc/ell.cu,
// with the same evict-first streams and slots in flight.)
//
// The second kernel waits for the first with programmatic dependent launch
// (griddepcontrol): its blocks start, and load their first slots, while
// the relabel finishes (0.8 us a launch of K13, PERF.md).
//
// The sum of a row runs over its slots in slot order, acc += v * x[col],
// exactly as K11's, on the same values: the result is bit for bit K11's
// (and K12's) on the same matrix as loaded, whatever the order of the rows.
// No atomics: two launches are bit-identical. Invalid slots hold val 0 and
// the relabelled column of col 0 (x'[..] = x[0]), as K11 adds 0 * x[0].

#include <cuda_runtime.h>

namespace {

// Threads a block (128 ran slower, 512 no faster, PERF.md).
constexpr int NT = 256;
constexpr long long MAX_BLOCKS = 65536;
// Slots a thread has in flight: their values and columns, then their
// gathers (8 ran slower on K13 in float32, PERF.md).
constexpr int U = 4;

// The values and columns are read once: evict-first (ld.global.cs), so that
// L1 and L2 keep x (__ldg streams ran 10-14% slower).
template <typename T>
__device__ __forceinline__ T ld_stream(const T* p) {
  return __ldcs(p);
}

// x2[j] = x[order[j]] for j < n (scattered loads: scattered stores,
// x2[inverse[i]] = x[i], ran 5-8% slower, PERF.md).
template <typename T>
__global__ void __launch_bounds__(NT)
    relabel_kernel(const T* __restrict__ x, const int* __restrict__ order, T* __restrict__ x2, long long n) {
  // the gather's blocks may start now; they wait for this grid to finish
  // (griddepcontrol.wait) before they read x2
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  const long long stride = (long long)gridDim.x * NT;
  for (long long j = (long long)blockIdx.x * NT + threadIdx.x; j < n; j += stride) x2[j] = __ldg(x + __ldg(order + j));
}

// y[order[i]] = sum_s vals[s, i] * x2[cols[s, i]].
template <typename T>
__global__ void __launch_bounds__(NT)
    scatter_spmv_kernel(const T* __restrict__ vals, const int* __restrict__ cols, int width,
                        const T* __restrict__ x2, const int* __restrict__ order, T* __restrict__ y, long long n) {
  const long long stride = (long long)gridDim.x * NT;
  long long i = (long long)blockIdx.x * NT + threadIdx.x;
  // The row's first slots (which do not depend on x2) are loaded before
  // the wait for the relabel, and the next row's after each row.
  const int head = width < U ? width : U;
  T v0[U];
  int c0[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    if (u < head && i < n) {
      v0[u] = ld_stream(vals + (long long)u * n + i);
      c0[u] = ld_stream(cols + (long long)u * n + i);
    }
  }
  asm volatile("griddepcontrol.wait;" ::: "memory");
  for (; i < n; i += stride) {
    T acc = T(0);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (u < head) acc += v0[u] * __ldg(x2 + c0[u]);
    }
    int s = head;
    for (; s + U <= width; s += U) {
      T v[U];
      int c[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        v[u] = ld_stream(vals + (long long)(s + u) * n + i);
        c[u] = ld_stream(cols + (long long)(s + u) * n + i);
      }
      T g[U];
#pragma unroll
      for (int u = 0; u < U; ++u) g[u] = __ldg(x2 + c[u]);
#pragma unroll
      for (int u = 0; u < U; ++u) acc += v[u] * g[u];
    }
    for (; s < width; ++s) acc += ld_stream(vals + (long long)s * n + i) * __ldg(x2 + ld_stream(cols + (long long)s * n + i));
    y[__ldg(order + i)] = acc;
    const long long next = i + stride;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (u < head && next < n) {
        v0[u] = ld_stream(vals + (long long)u * n + next);
        c0[u] = ld_stream(cols + (long long)u * n + next);
      }
    }
  }
}

template <typename T>
int launch_scatter(const T* vals, const int* cols, int width, const int* order, const T* x, T* x2, T* y, long long n,
                   void* stream) {
  if (n < 1 || width < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  long long blocks = (n + NT - 1) / NT;
  if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
  relabel_kernel<T><<<(unsigned)blocks, NT, 0, s>>>(x, order, x2, n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.gridDim = dim3((unsigned)blocks);
  cfg.blockDim = dim3(NT);
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, scatter_spmv_kernel<T>, vals, cols, width, (const T*)x2, order, y, n);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// vals, cols: (width, n) slot-major, rows in work order; cols index x2, x
// relabelled by order. order: (n,) the row each work position computes.
// x2: (n,) scratch. y: (n,), must not alias x or x2.
int hpccg_ell_scatter_f32(const float* vals, const int* cols, int width, const int* order, const float* x, float* x2,
                          float* y, long long n, void* stream) {
  return launch_scatter<float>(vals, cols, width, order, x, x2, y, n, stream);
}

int hpccg_ell_scatter_f64(const double* vals, const int* cols, int width, const int* order, const double* x,
                          double* x2, double* y, long long n, void* stream) {
  return launch_scatter<double>(vals, cols, width, order, x, x2, y, n, stream);
}

}  // extern "C"
