// Collective whole-solve CG kernel for a banded explicit (DIA) matrix on
// Hopper (sm_90a): K17 of the port.
//
// Replaces the TPU kernel hpccg_tpu/ops/pallas/collective_kernel.py:
// _kernel_dia (:906, called at :1111 by cg_collective_dia_padded), which runs
// the drivers _cg_whole_solve (METHOD = CG, the reference recurrence, two
// allreduces per iteration) and _cg1_whole_solve (CG1, Chronopoulos-Gear,
// one) with a DIA apply over the shard's rows. So does this kernel: the
// ranks, the protocol and the drivers are K15's (collective.cuh); this file
// holds the DIA view of a rank and the entry points. One cooperative launch
// solves every rank of a one-card mesh; float and double instances.
//
// Rows and the halo. Rank r owns global rows [r*L, (r+1)*L); its diagonal
// data is the (ndiag, L) column block of the matrix's data (row-major by
// diagonal), read through the P_DATA row of the pointer table. Row i of
// rank r reads x at i + off for every offset, and the band reaches at most
// bw_lo = max(0, -min off) rows below and bw_hi = max(0, max off) above
// (both <= L: neighbours only). So the pass that produces an exchanged
// vector pushes two strips of rows: rows i < bw_hi into rank r-1's "from
// above" landing strip, rows i >= L - bw_lo into rank r+1's "from below"
// strip (with a band as wide as the shard, one row goes both ways). Each
// rank has (2 phases, 2 sides, max(bw_lo, bw_hi)) landing strips, zero at
// the global ends: that zero is the band's clipping (the data there is zero
// too, and 0 * 0 stays 0). cg exchanges p, cg1 x at the init and r in every
// iteration, as the JAX kernel does (collective_kernel.py:1042).
//
// The apply. Each rank's blocks take its rows in a grid-stride loop, four
// consecutive rows per thread, reading a diagonal's data for the four in
// one 16-byte load (two for double); the offsets sit in shared memory
// (staged once when they fit one chunk of OFF_CHUNK, else chunk by chunk as
// in K9). The TPU's trace-time unroll of the offsets (its 128-diagonal
// cap) and its VMEM-pinned data have no counterpart: the data streams from
// device memory. The sum of each row runs in offset order with every
// product and sum rounded on its own (hpccg::mul_rn/add_rn), so the apply
// is bit-identical to the plain dia-halo matvec (DiaRows.matvec over
// BandStrips). The dots use K15's block trees and rank-order sums, where
// JAX uses recursive doubling at 4 and 8 ranks: traces part from JAX's in
// the last bits.
//
// What bounds it on this card: memory bandwidth. A cg iteration reads the
// diagonal data once (ndiag*n*s bytes) and makes K15's vector passes (about
// 11 n*s): at 4 x 128^3 f32 rows and 27 diagonals, 226.5 MB of data and
// 92.3 MB of vectors, ~95 us at 3.35 TB/s. What the design does about it,
// as measured on an H100 (PERF.md, Findings): the blocks per SM move the time
// most (the float instance is bound to 3, 80 registers: 494 -> 356 us per
// cg iteration at 4 x 128^3/4), then four rows per thread with vector loads
// of the data (-> 229). The apply reads x with plain (L1-cached) loads:
// the vector it reads was written before the rank barrier or allreduce
// that the reading block passed with an acquire, so no stale line is
// read. The update passes read through L2 (__ldcg), as K15's do. No TMA,
// no clusters yet.

#include <cuda_runtime.h>
#include <stdint.h>

#include "collective.cuh"

namespace {

using namespace hpccg::coll;
using hpccg::add_rn;
using hpccg::mul_rn;

constexpr int NT = 256;
constexpr int OFF_CHUNK = 1024;  // offsets staged per pass: 4 KB of shared memory
constexpr int RPT = 4;           // rows per thread in the apply

__device__ __forceinline__ void load4(const float* p, float* out) {
  const float4 q = __ldg(reinterpret_cast<const float4*>(p));
  out[0] = q.x;
  out[1] = q.y;
  out[2] = q.z;
  out[3] = q.w;
}

__device__ __forceinline__ void load4(const double* p, double* out) {
  const double2 a = __ldg(reinterpret_cast<const double2*>(p));
  const double2 b = __ldg(reinterpret_cast<const double2*>(p) + 1);
  out[0] = a.x;
  out[1] = a.y;
  out[2] = b.x;
  out[3] = b.y;
}

// The RPT values at p (rows i0.. of one diagonal), `left` rows remaining.
template <typename T>
__device__ __forceinline__ void load_rows(const T* p, int64_t left, bool aligned, T* out) {
  if (aligned) {
    load4(p, out);
    return;
  }
#pragma unroll
  for (int r = 0; r < RPT; ++r) out[r] = r < left ? __ldg(p + r) : T(0);
}

template <typename T>
struct DiaParams {
  Common<T> c;
  const int* offsets;  // (ndiag,) increasing, shared by the ranks
  long long L;         // rows per rank
  int ndiag, bw_lo, bw_hi, width;
};

// One block's view of its rank of the banded matrix.
template <typename T>
struct DiaRank : Comm<T, T, NT> {
  using Base = Comm<T, T, NT>;
  int* s_off;
  const int* offsets;
  int ndiag, bw_lo, bw_hi, width;

  __device__ DiaRank(const DiaParams<T>& p, T* red, int* s) : Base(p.c, red, threadIdx.x, p.L), s_off(s) {
    offsets = p.offsets;
    ndiag = p.ndiag;
    bw_lo = p.bw_lo;
    bw_hi = p.bw_hi;
    width = p.width;
    if (staged()) {
      for (int j = threadIdx.x; j < ndiag; j += NT) s_off[j] = offsets[j];
      __syncthreads();
    }
  }

  __device__ bool staged() const { return ndiag <= OFF_CHUNK; }

  // Real row i of a vector goes to the neighbours' landing strips of phase
  // ph: the first bw_hi rows to the rank below, the last bw_lo to the rank
  // above.
  __device__ void push(int ph, int64_t i, T v) {
    const int rank = this->rank;
    if (i < bw_hi && rank > 0) this->template ptr<T>(P_H, rank - 1)[(int64_t)(2 * ph + 1) * width + i] = v;
    const int64_t first = this->n - bw_lo;
    if (i >= first && rank < this->ndev - 1) {
      this->template ptr<T>(P_H, rank + 1)[(int64_t)2 * ph * width + (i - first)] = v;
    }
  }

  // A v over the rank's rows, with phase ph's landing strips as the rows
  // below and above: emit(i, c, y) with c = v[i], y = (A v)[i]. Four
  // consecutive rows per thread, a diagonal's data for them in one 16-byte
  // load (two for double) where the rows are aligned.
  template <typename Emit>
  __device__ void apply(int kind, int ph, Emit&& emit) {
    const int64_t n = this->n;
    const T* v = this->vec(kind);
    const T* lo = this->template ptr<T>(P_H, this->rank) + (int64_t)2 * ph * width;
    const T* hi = lo + width;
    const T* data = this->template ptr<T>(P_DATA, this->rank);
    const bool aligned = n % RPT == 0 && reinterpret_cast<uintptr_t>(data) % (RPT * sizeof(T)) == 0;
    // the loop bound is the same for every thread of a block, so all of
    // them reach the barriers of the chunked staging
    for (int64_t base = (int64_t)this->lb * NT * RPT; base < n; base += (int64_t)this->bpr * NT * RPT) {
      const int64_t i0 = base + (int64_t)this->tid * RPT;
      T acc[RPT];
#pragma unroll
      for (int r = 0; r < RPT; ++r) acc[r] = T(0);
      for (int c0 = 0; c0 < ndiag; c0 += OFF_CHUNK) {
        const int m = min(OFF_CHUNK, ndiag - c0);
        if (!staged()) {
          __syncthreads();  // the previous chunk's readers are done
          for (int j = threadIdx.x; j < m; j += NT) s_off[j] = offsets[c0 + j];
          __syncthreads();
        }
        if (i0 < n) {
          const T* d = data + (int64_t)c0 * n + i0;
#pragma unroll 2
          for (int j = 0; j < m; ++j) {
            T dv[RPT];
            load_rows(d + (int64_t)j * n, n - i0, aligned, dv);
            const int64_t c0r = i0 + s_off[j];
#pragma unroll
            for (int r = 0; r < RPT; ++r) {
              const int64_t c = c0r + r;
              if (i0 + r < n) {
                const T xv = c < 0 ? lo[c + bw_lo] : (c >= n ? hi[c - n] : v[c]);
                acc[r] = add_rn(acc[r], mul_rn(dv[r], xv));
              }
            }
          }
        }
      }
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        if (i0 + r < n) emit(i0 + r, __ldcg(v + i0 + r), acc[r]);
      }
    }
  }
};

// float: 3 blocks per SM (80 registers); double: 2 (128)
template <typename T, int METHOD>
__global__ void __launch_bounds__(NT, sizeof(T) == 4 ? 3 : 2) collective_dia_kernel(const DiaParams<T> P) {
  __shared__ T red[NT];
  __shared__ int s_off[OFF_CHUNK];
  DiaRank<T> R(P, red, s_off);
  if (METHOD == CG) {
    solve_cg(R);
  } else {
    solve_cg1(R);
  }
}

template <typename T>
const void* kernel_for(int method) {
  return method == CG ? (const void*)collective_dia_kernel<T, CG> : (const void*)collective_dia_kernel<T, CG1>;
}

template <typename T>
int resident_blocks(int method, int* blocks) {
  if (method != CG && method != CG1) return (int)cudaErrorInvalidValue;
  return occupancy_blocks(kernel_for<T>(method), NT, blocks);
}

template <typename T>
int launch(const long long* ptrs, const int* offsets, T* trace, T* stats, int* err, int ndev, int bpr, long long L,
           int ndiag, int bw_lo, int bw_hi, int method, int max_iter, double tol, long long wait_ns, void* stream) {
  int resident = 0;
  const int e = resident_blocks<T>(method, &resident);
  if (e != (int)cudaSuccess) return e;
  if (ndev < 1 || bpr < 1 || L < 1 || ndiag < 1 || bw_lo < 0 || bw_hi < 0 || bw_lo > L || bw_hi > L ||
      wait_ns < 0) {
    return (int)cudaErrorInvalidValue;
  }
  if ((long long)ndev * bpr > resident) return (int)cudaErrorCooperativeLaunchTooLarge;
  DiaParams<T> params{{ptrs, trace, stats, err, ndev, bpr, max_iter, T(tol), (unsigned long long)wait_ns},
                      offsets, L, ndiag, bw_lo, bw_hi, bw_lo > bw_hi ? bw_lo : bw_hi};
  void* args[] = {&params};
  return (int)cudaLaunchCooperativeKernel(kernel_for<T>(method), dim3(ndev * bpr), dim3(NT), args, 0,
                                          (cudaStream_t)stream);
}

}  // namespace

extern "C" {

// Blocks resident at once for K17 (dtype 0 float32, 1 float64; method 0 cg,
// 1 cg1), or minus a CUDA error code: the grid of a launch is ndev x bpr
// blocks and must not exceed it.
int hpccg_collective_dia_resident_blocks(int dtype, int method) {
  int blocks = 0;
  int err = (int)cudaErrorInvalidValue;
  if (dtype == 0) err = resident_blocks<float>(method, &blocks);
  if (dtype == 1) err = resident_blocks<double>(method, &blocks);
  return err == (int)cudaSuccess ? blocks : -err;
}

// Rows a block takes at a time (NT threads x RPT rows): a rank's blocks
// take its rows in such tiles.
int hpccg_collective_dia_block_rows() { return NT * RPT; }

// ptrs: the NKIND x ndev pointer table (collective.cuh); offsets: (ndiag,)
// int32; landing strips (P_H) of (2, 2, max(bw_lo, bw_hi)) per rank.
int hpccg_collective_dia_f32(const long long* ptrs, const int* offsets, float* trace, float* stats, int* err,
                             int ndev, int bpr, long long L, int ndiag, int bw_lo, int bw_hi, int method,
                             int max_iter, double tol, long long wait_ns, void* stream) {
  return launch<float>(ptrs, offsets, trace, stats, err, ndev, bpr, L, ndiag, bw_lo, bw_hi, method, max_iter, tol,
                       wait_ns, stream);
}

int hpccg_collective_dia_f64(const long long* ptrs, const int* offsets, double* trace, double* stats, int* err,
                             int ndev, int bpr, long long L, int ndiag, int bw_lo, int bw_hi, int method,
                             int max_iter, double tol, long long wait_ns, void* stream) {
  return launch<double>(ptrs, offsets, trace, stats, err, ndev, bpr, L, ndiag, bw_lo, bw_hi, method, max_iter,
                        tol, wait_ns, stream);
}

}  // extern "C"
