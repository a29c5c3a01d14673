// DIA SpMV for Hopper (sm_90a): K9 (float) and K10 (double).
//
// Replaces hpccg_tpu/ops/pallas/dia_kernel.py:_kernel (K9) and :_kernel_dd
// (K10): y[i] = sum_d data[d, i] * x[i + off_d] for a banded explicit matrix.
// The TPU kernel streams (8 diagonal x 256x128) blocks of the data, keeps a
// bandwidth-padded x in VMEM and scalar-prefetches the offsets; K10 carries
// f64 as (hi, lo) f32 pairs because Mosaic has no f64. Hopper has a gather
// and native f64, so K10 is this kernel's double instance.
//
// The x window. On one device x is the matrix's own vector (xlo = 0, xlen =
// n). On a rank of a mesh (the dia-halo tier, parallel/cg.py) the kernel
// reads the rank's extended vector x_ext = [bw_lo rows of the rank below |
// its L rows | bw_hi rows of the rank above] (parallel/halo.py:BandStrips):
// row i reads x[i + xlo + off_d] with xlo = bw_lo, within [0, xlen), xlen =
// L + bw_lo + bw_hi. The strips are zero at the global ends, which is the
// band's clipping. This takes the place of the TPU's zero-halo kernel plus
// boundary corrections (hpccg_tpu/parallel/cg.py:1194-1207), which exist so
// that XLA can overlap the ppermute with the kernel.
//
// What bounds it on the card: memory bandwidth. Each row reads ndiag data
// values (diagonal-major, so a warp's reads coalesce), x at ndiag shifted
// positions (coalesced too, and mostly L1/L2 hits: neighbouring diagonals
// read overlapping windows of x), and writes y: ndiag*n*s + 2n*s bytes per
// SpMV. What the design does about it: one thread per row in a grid-stride
// loop (64-bit row and offset arithmetic), no padding of x or the data
// (a diagonal's slot is read only where its column lies inside x: DIA
// stores zeros outside each diagonal, and x is never read out of bounds),
// and the offsets (<= 4096 int32) staged through shared memory in chunks.
//
// The sum runs in offset order with every product and sum rounded on its
// own (no FMA contraction), the order and the roundings of the plain torch
// version (one sliced multiply-add per diagonal), so kernel and plain agree
// bit for bit. No atomics: two launches are bit-identical.

#include "reduce.cuh"

namespace {

using hpccg::add_rn;
using hpccg::mul_rn;

constexpr int NT = 256;
constexpr int OFF_CHUNK = 1024;         // offsets staged per pass: 4 KB of shared memory
constexpr long long MAX_BLOCKS = 65536;  // grid-stride beyond 16M rows

// WINDOW: x is a rank's extended vector (row i reads x[i + xlo + off],
// within [0, xlen)); else the matrix's own (xlo = 0, xlen = n). Two
// instances, because the window's bounds cost the one-device kernel 25% in
// float and 12% in double on an H100 (PERF.md, Findings).
template <typename T, bool WINDOW>
__global__ void __launch_bounds__(NT)
    dia_spmv_kernel(const T* __restrict__ data, const int* __restrict__ offsets, int ndiag,
                    const T* __restrict__ x, T* __restrict__ y, long long n, long long xlo, long long xlen) {
  __shared__ int s_off[OFF_CHUNK];
  const long long stride = (long long)gridDim.x * NT;
  // the loop bound is the same for every thread of a block, so all of them
  // reach the barriers
  for (long long base = (long long)blockIdx.x * NT; base < n; base += stride) {
    const long long row = base + threadIdx.x;
    const bool in = row < n;
    T acc = T(0);
    for (int c0 = 0; c0 < ndiag; c0 += OFF_CHUNK) {
      const int m = min(OFF_CHUNK, ndiag - c0);
      __syncthreads();  // the previous chunk's readers are done
      for (int j = threadIdx.x; j < m; j += NT) s_off[j] = offsets[c0 + j];
      __syncthreads();
      if (in) {
        const T* d = data + (long long)c0 * n + row;
        for (int j = 0; j < m; ++j) {
          const long long col = row + (WINDOW ? xlo : 0) + (long long)s_off[j];
          if (col >= 0 && col < (WINDOW ? xlen : n)) acc = add_rn(acc, mul_rn(d[(long long)j * n], __ldg(x + col)));
        }
      }
    }
    if (in) y[row] = acc;
  }
}

template <typename T>
int launch_dia(const T* data, const int* offsets, int ndiag, const T* x, T* y, long long n, long long xlo,
               long long xlen, void* stream) {
  if (n < 1 || ndiag < 0 || xlo < 0 || xlen < n + xlo) return (int)cudaErrorInvalidValue;
  long long blocks = (n + NT - 1) / NT;
  if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
  const auto kernel = xlo == 0 && xlen == n ? dia_spmv_kernel<T, false> : dia_spmv_kernel<T, true>;
  kernel<<<(unsigned)blocks, NT, 0, (cudaStream_t)stream>>>(data, offsets, ndiag, x, y, n, xlo, xlen);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// data: (ndiag, n) diagonal-major; offsets: (ndiag,) int32, increasing; x:
// xlen entries, row i reading x[i + xlo + offsets[d]] (xlo = 0, xlen = n on
// one device).
int hpccg_dia_f32(const float* data, const int* offsets, int ndiag, const float* x, float* y, long long n,
                  long long xlo, long long xlen, void* stream) {
  return launch_dia<float>(data, offsets, ndiag, x, y, n, xlo, xlen, stream);
}

int hpccg_dia_f64(const double* data, const int* offsets, int ndiag, const double* x, double* y, long long n,
                  long long xlo, long long xlen, void* stream) {
  return launch_dia<double>(data, offsets, ndiag, x, y, n, xlo, xlen, stream);
}

}  // extern "C"
