// ELL gather SpMV for Hopper (sm_90a): K11 (float, and its bfloat16-storage
// instance) and K12 (double), which also computes what K13 and K14 compute.
//
// Replaces hpccg_tpu/ops/pallas/gell_kernel.py:_kernel (K11) and :_kernel_dd
// (K12), and the wide-scatter tiers gell_stack.py:_kernel_stack(_dd) (K13)
// and gell_dynwin.py:_kernel_dynwin(_dd) (K14). The TPU has no hardware
// gather: its kernels scan 128-lane chunks of an x window per 1024-row tile
// (K11), bucket slots into strips at static window offsets (K13) or give
// each (tile, slot) its own window base (K14), and carry f64 as (hi, lo)
// f32 pairs. Hopper gathers natively and has f64, so one kernel computes
// y[i] = sum_s vals[s, i] * x[cols[s, i]] for every class of matrix, and
// the f64 tiers are its double instance.
//
// What bounds it on the card: memory bandwidth. It streams every padded
// slot, width*n*(s + 4) bytes of values and int32 columns, plus the x it
// gathers and y: width*n*(s+4) + 2n*s per SpMV, the x reads served from L2
// as far as the column pattern keeps them near each other. What the design
// does about it: the matrix is slot-major ((width, n), built once per matrix
// by prepare_ell), so a warp's value and column reads coalesce; one thread
// per row in a grid-stride loop with 64-bit indexing; x is read through the
// read-only path (__ldg). Invalid slots hold val 0 and col 0 and add
// 0 * x[0], as the JAX package's take + einsum does. Skewed row lengths
// stream every padded slot; sliced ELL or CSR would not (later work).
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

namespace {

using hpccg::from_s;
using hpccg::to_s;

constexpr int NT = 256;
constexpr long long MAX_BLOCKS = 65536;

template <typename T, typename S>
__global__ void __launch_bounds__(NT)
    ell_spmv_kernel(const T* __restrict__ vals, const int* __restrict__ cols, int width,
                    const T* __restrict__ x, T* __restrict__ y, long long n) {
  const long long stride = (long long)gridDim.x * NT;
  for (long long row = (long long)blockIdx.x * NT + threadIdx.x; row < n; row += stride) {
    S acc = S(0);
#pragma unroll 4
    for (int s = 0; s < width; ++s) {
      const long long k = (long long)s * n + row;
      acc += to_s(vals[k]) * to_s(__ldg(x + cols[k]));
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
