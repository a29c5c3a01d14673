// DIA SpMV for Hopper (sm_90a): K9 (float, and its bfloat16-storage
// instance) and K10 (double).
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
//
// bfloat16 (T = __nv_bfloat16, S = float; storage.cuh): data, x and y are
// stored in bf16, the sum runs in f32 (a product of two bf16 values is exact
// in f32) and y is rounded once, as the plain version does it. It halves the
// bytes: 27 n * 2 + 2 n * 2 per SpMV for a 27-diagonal band; four rows per
// thread keep 8 bytes in each load (dia_spmv_bf16_rows_kernel). The JAX
// package's K9 is float32 only (dia_kernel.py:60-65) and its bf16 DIA
// matvec is XLA's; this instance runs the same solves on the card.

#include <stdint.h>

#include "reduce.cuh"
#include "storage.cuh"

namespace {

using hpccg::add_rn;
using hpccg::from_s;
using hpccg::mul_rn;
using hpccg::to_s;

constexpr int NT = 256;
constexpr int OFF_CHUNK = 1024;         // offsets staged per pass: 4 KB of shared memory
constexpr long long MAX_BLOCKS = 65536;  // grid-stride beyond 16M rows

// WINDOW: x is a rank's extended vector (row i reads x[i + xlo + off],
// within [0, xlen)); else the matrix's own (xlo = 0, xlen = n). Two
// instances, because the window's bounds cost the one-device kernel 25% in
// float and 12% in double on an H100 (PERF.md, Findings).
template <typename T, typename S, bool WINDOW>
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
    S acc = S(0);
    for (int c0 = 0; c0 < ndiag; c0 += OFF_CHUNK) {
      const int m = min(OFF_CHUNK, ndiag - c0);
      __syncthreads();  // the previous chunk's readers are done
      for (int j = threadIdx.x; j < m; j += NT) s_off[j] = offsets[c0 + j];
      __syncthreads();
      if (in) {
        const T* d = data + (long long)c0 * n + row;
        for (int j = 0; j < m; ++j) {
          const long long col = row + (WINDOW ? xlo : 0) + (long long)s_off[j];
          if (col >= 0 && col < (WINDOW ? xlen : n)) {
            acc = add_rn(acc, mul_rn(to_s(d[(long long)j * n]), to_s(__ldg(x + col))));
          }
        }
      }
    }
    if (in) y[row] = from_s<T>(acc);
  }
}

// bfloat16, BF16_ROWS rows per thread: their data values of a diagonal
// read in one load of 2 * BF16_ROWS bytes and y written in one store, where
// n is a multiple of BF16_ROWS and data and y are aligned to the load
// (the 128^3 main path and its 4-rank shards; launch_dia falls back to
// dia_spmv_kernel otherwise). Each row's sum is dia_spmv_kernel's (offset
// order, every product and sum rounded on its own): the same bits. 4 rows
// (8-byte loads) is the build's choice; 1, 2 and 8 build with
// HPCCG_DIA_BF16_ROWS defined to R (scripts/dia_bf16_rows.py times them:
// one row per thread ran slower than the float instance, PERF.md).
#ifndef HPCCG_DIA_BF16_ROWS
#define HPCCG_DIA_BF16_ROWS 4
#endif
constexpr int BF16_ROWS = HPCCG_DIA_BF16_ROWS;

template <int R>
struct RowsLoad;  // the load of R bf16 values
template <>
struct RowsLoad<1> {
  using type = unsigned short;
};
template <>
struct RowsLoad<2> {
  using type = unsigned int;
};
template <>
struct RowsLoad<4> {
  using type = uint2;
};
template <>
struct RowsLoad<8> {
  using type = uint4;
};
using RowsVec = RowsLoad<BF16_ROWS>::type;

template <bool WINDOW>
__global__ void __launch_bounds__(NT)
    dia_spmv_bf16_rows_kernel(const __nv_bfloat16* __restrict__ data, const int* __restrict__ offsets, int ndiag,
                              const __nv_bfloat16* __restrict__ x, __nv_bfloat16* __restrict__ y, long long n,
                              long long xlo, long long xlen) {
  __shared__ int s_off[OFF_CHUNK];
  const long long ngroup = n / BF16_ROWS;
  const long long stride = (long long)gridDim.x * NT;
  const long long lim = WINDOW ? xlen : n;
  const RowsVec* dv = reinterpret_cast<const RowsVec*>(data);
  for (long long base = (long long)blockIdx.x * NT; base < ngroup; base += stride) {
    const long long g = base + threadIdx.x;
    const bool in = g < ngroup;
    const long long row = (long long)BF16_ROWS * g;
    float acc[BF16_ROWS];
#pragma unroll
    for (int r = 0; r < BF16_ROWS; ++r) acc[r] = 0.f;
    for (int c0 = 0; c0 < ndiag; c0 += OFF_CHUNK) {
      const int m = min(OFF_CHUNK, ndiag - c0);
      __syncthreads();  // the previous chunk's readers are done
      for (int j = threadIdx.x; j < m; j += NT) s_off[j] = offsets[c0 + j];
      __syncthreads();
      if (in) {
        const RowsVec* d = dv + (long long)c0 * ngroup + g;
        for (int j = 0; j < m; ++j) {
          const long long col = row + (WINDOW ? xlo : 0) + (long long)s_off[j];
          const RowsVec raw = d[(long long)j * ngroup];
          const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
          for (int r = 0; r < BF16_ROWS; ++r) {
            if (col + r >= 0 && col + r < lim) acc[r] = add_rn(acc[r], mul_rn(to_s(e[r]), to_s(__ldg(x + col + r))));
          }
        }
      }
    }
    if (in) {
      RowsVec out;
      __nv_bfloat16* o = reinterpret_cast<__nv_bfloat16*>(&out);
#pragma unroll
      for (int r = 0; r < BF16_ROWS; ++r) o[r] = __float2bfloat16(acc[r]);
      reinterpret_cast<RowsVec*>(y)[g] = out;
    }
  }
}

template <typename T, typename S>
int launch_dia(const T* data, const int* offsets, int ndiag, const T* x, T* y, long long n, long long xlo,
               long long xlen, void* stream) {
  if (n < 1 || ndiag < 0 || xlo < 0 || xlen < n + xlo) return (int)cudaErrorInvalidValue;
  long long blocks = (n + NT - 1) / NT;
  if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
  if constexpr (sizeof(T) == 2) {
    if (n % BF16_ROWS == 0 && (uintptr_t)data % sizeof(RowsVec) == 0 && (uintptr_t)y % sizeof(RowsVec) == 0) {
      long long groups = (n / BF16_ROWS + NT - 1) / NT;
      if (groups > MAX_BLOCKS) groups = MAX_BLOCKS;
      const auto kr = xlo == 0 && xlen == n ? dia_spmv_bf16_rows_kernel<false> : dia_spmv_bf16_rows_kernel<true>;
      kr<<<(unsigned)groups, NT, 0, (cudaStream_t)stream>>>(data, offsets, ndiag, x, y, n, xlo, xlen);
      return (int)cudaGetLastError();
    }
  }
  const auto kernel = xlo == 0 && xlen == n ? dia_spmv_kernel<T, S, false> : dia_spmv_kernel<T, S, true>;
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
  return launch_dia<float, float>(data, offsets, ndiag, x, y, n, xlo, xlen, stream);
}

int hpccg_dia_f64(const double* data, const int* offsets, int ndiag, const double* x, double* y, long long n,
                  long long xlo, long long xlen, void* stream) {
  return launch_dia<double, double>(data, offsets, ndiag, x, y, n, xlo, xlen, stream);
}

int hpccg_dia_bf16(const __nv_bfloat16* data, const int* offsets, int ndiag, const __nv_bfloat16* x,
                   __nv_bfloat16* y, long long n, long long xlo, long long xlen, void* stream) {
  return launch_dia<__nv_bfloat16, float>(data, offsets, ndiag, x, y, n, xlo, xlen, stream);
}

}  // extern "C"
