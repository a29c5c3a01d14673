// ELL gather SpMV for Hopper (sm_90a): K11 (float) and K12 (double), which
// also computes what K13 and K14 compute.
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
// The sum runs in slot order, in T. No atomics: two launches are
// bit-identical.

namespace {

constexpr int NT = 256;
constexpr long long MAX_BLOCKS = 65536;

template <typename T>
__global__ void __launch_bounds__(NT)
    ell_spmv_kernel(const T* __restrict__ vals, const int* __restrict__ cols, int width,
                    const T* __restrict__ x, T* __restrict__ y, long long n) {
  const long long stride = (long long)gridDim.x * NT;
  for (long long row = (long long)blockIdx.x * NT + threadIdx.x; row < n; row += stride) {
    T acc = T(0);
#pragma unroll 4
    for (int s = 0; s < width; ++s) {
      const long long k = (long long)s * n + row;
      acc += vals[k] * __ldg(x + cols[k]);
    }
    y[row] = acc;
  }
}

template <typename T>
int launch_ell(const T* vals, const int* cols, int width, const T* x, T* y, long long n,
               void* stream) {
  if (n < 1 || width < 0) return (int)cudaErrorInvalidValue;
  long long blocks = (n + NT - 1) / NT;
  if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
  ell_spmv_kernel<T><<<(unsigned)blocks, NT, 0, (cudaStream_t)stream>>>(vals, cols, width, x, y, n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// vals: (width, n) slot-major; cols: (width, n) int32 in [0, len(x)).
int hpccg_ell_f32(const float* vals, const int* cols, int width, const float* x, float* y,
                  long long n, void* stream) {
  return launch_ell<float>(vals, cols, width, x, y, n, stream);
}

int hpccg_ell_f64(const double* vals, const int* cols, int width, const double* x, double* y,
                  long long n, void* stream) {
  return launch_ell<double>(vals, cols, width, x, y, n, stream);
}

}  // extern "C"
