// Collective whole-solve CG kernel for a banded explicit (DIA) matrix on
// Hopper (sm_90a): K17 of the port.
//
// Replaces the TPU kernel hpccg_tpu/ops/pallas/collective_kernel.py:
// _kernel_dia (:906, called at :1111 by cg_collective_dia_padded), which runs
// the drivers _cg_whole_solve (METHOD = CG, the reference recurrence, two
// allreduces per iteration) and _cg1_whole_solve (CG1, Chronopoulos-Gear,
// one) with a DIA apply over the shard's rows. So does this kernel: the
// ranks and the protocol are K15's (collective.cuh); this file holds the
// DIA view of a rank, the two drivers and the entry points. One cooperative
// launch solves every rank of a one-card mesh; float and double instances.
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
// What bounds it on this card: memory bandwidth. A cg iteration reads the
// diagonal data once (ndiag*n*s bytes) and makes 10 vector passes of n*s
// (cg1: 11): at 4 x 128^3 f32 rows and 27 diagonals, 226.5 MB of data and
// 84-92 MB of vectors, ~92-95 us at 3.35 TB/s. The TPU's trace-time unroll of
// the offsets (its 128-diagonal cap) and its VMEM-pinned data have no
// counterpart: the data streams from device memory.
//
// The design (measured on an H100: PERF.md, Findings). Its first form (a
// grid-stride loop of four rows a thread, two diagonals' data in flight, x
// read behind a three-way select, 4-byte passes, system-scoped counters)
// took 225 us per f32 cg iteration at 4 x 128^3/4, of which the apply
// 130, the protocol 70 and the passes 26.
//   - Tiles. A thread owns R consecutive rows (4: one 16-byte word of
//     float, two of double) in the apply and in every pass, so a pass reads
//     only what the same thread wrote before it; a block's TILE = NT x R
//     rows. Block lb of a rank takes the rank's tiles lb, lb + bpr, ...
//   - The protocol's counters and fences have device scope: every rank of a
//     launch lives on this card. The scope is a template argument of the
//     kernel; a multi-card launch would take the system's.
//   - The passes move a thread's rows as 16-byte accesses through L2
//     (__ldcg), one element at a time in a rank's last, short group and
//     for b and x0 where they are views at offsets that are not 16-byte
//     aligned. A pushed strip row is stored on its own (the strips are a
//     few % of the rows). cg folds x += alpha p into the next iteration's p
//     pass, which reads p anyway (the same formula, so the same bits), and
//     adds one x pass at the exit: 10 passes an iteration, not 11. Every
//     update is rounded one operation at a time (add_rn/mul_rn).
//   - The apply stages each (tile, diagonal) segment of the data, TILE
//     consecutive values, by cp.async.bulk (the Tensor Memory Accelerator's
//     1-D copy) into a ring of NS stages in shared memory, each completing
//     on its own mbarrier: thread 0 keeps NS - U to NS segments in flight,
//     so the data in flight costs no registers. The copies ask L2 to evict
//     the data first, so that the vectors stay in L2. The ring needs a
//     16-byte aligned data block and L a multiple of a word's values;
//     otherwise the apply reads the data directly, one value at a time, in
//     the same kernel. A ring wait that lasts RING_WAIT_NS traps: the
//     block's own copy faulted (the protocol's waits have their own limit
//     and error word).
//   - The diagonals go in steps of U: a step's x loads are issued together,
//     then its data and sums, then a block barrier and the step's stages
//     refilled. A tile whose every row reaches only rows inside [0, L) (and
//     a word more) reads each diagonal's x as R / V + 1 aligned 16-byte
//     words and selects the R values; a tile within the band of a rank's
//     ends selects, row by row, between the landing strips and the rank's
//     vector. x is read through L1: the vector was written before the rank
//     barrier or allreduce that the reading block passed with an acquire,
//     which leaves no stale line.
//   - Each row's sum runs in offset order, every product and sum rounded on
//     its own, so the apply is bit-identical to the plain dia-halo matvec
//     (DiaRows.matvec over BandStrips). The dots are per-thread sums, then
//     K15's block trees and rank-order sums (JAX uses recursive doubling at
//     4 and 8 ranks: traces part from JAX's in the last bits).
//
// HPCCG_DIA_SYNC_ONLY=1 builds a variant whose passes and apply do no vector
// work (the protocol alone), HPCCG_DIA_APPLY_ONLY=1 one whose passes do
// none, both running max_iter iterations whatever the residual; the blocks
// per SM (HPCCG_DIA_BLOCKS for float cg, HPCCG_DIA_BLOCKS_CG1,
// HPCCG_DIA_BLOCKS_F64: the launch bound) are compile-time constants too,
// chosen by measurement. Only scripts/collective_dia_sweep.py sets them.

#include <cuda/atomic>
#include <cuda_runtime.h>
#include <stdint.h>

#include "collective.cuh"
#include "reduce.cuh"

#ifndef HPCCG_DIA_SYNC_ONLY
#define HPCCG_DIA_SYNC_ONLY 0
#endif
#ifndef HPCCG_DIA_APPLY_ONLY
#define HPCCG_DIA_APPLY_ONLY 0
#endif
#ifndef HPCCG_DIA_BLOCKS
#define HPCCG_DIA_BLOCKS 4
#endif
#ifndef HPCCG_DIA_BLOCKS_CG1
#define HPCCG_DIA_BLOCKS_CG1 3
#endif
#ifndef HPCCG_DIA_BLOCKS_F64
#define HPCCG_DIA_BLOCKS_F64 2
#endif

namespace {

using namespace hpccg::coll;
using hpccg::add_rn;
using hpccg::mul_rn;

constexpr int NT = 256;
constexpr int OFF_CHUNK = 1024;  // offsets kept in shared memory (4 KB); the rest are read through L1
constexpr bool SYNC_ONLY = HPCCG_DIA_SYNC_ONLY != 0;
constexpr bool FIXED = SYNC_ONLY || HPCCG_DIA_APPLY_ONLY != 0;
// The ring's stages (NS), the diagonals of a step (U) and the rows a thread
// (R_ROWS: one 16-byte word of float, two of double), as measured on an
// H100 (PERF.md: direct loads instead of the ring, no L2 hint, 4 or 12
// stages, 8 rows a thread and, in float, steps of 1 or 2 all lost).
constexpr int NS = 8, U = 4, R_ROWS = 4;
constexpr unsigned long long RING_WAIT_NS = 2000000000ull;
static_assert(U >= 1 && NS >= 2 * U && R_ROWS % 4 == 0, "ring constants");
static_assert(HPCCG_DIA_BLOCKS >= 1 && HPCCG_DIA_BLOCKS_CG1 >= 1 && HPCCG_DIA_BLOCKS_F64 >= 1,
              "blocks per SM");
// every rank of a launch shares this card
constexpr cuda::thread_scope SCOPE = cuda::thread_scope_device;

// 16 bytes of T
template <typename T>
struct Wide;
template <>
struct Wide<float> {
  using W = float4;
};
template <>
struct Wide<double> {
  using W = double2;
};

// The ring's bytes: NS stages of a tile's rows of one diagonal.
template <typename T>
constexpr int smem_bytes() {
  return NS * NT * R_ROWS * (int)sizeof(T);
}

// Resident blocks per SM, at most (the kernel's launch bound): float cg 4
// (64 registers), float cg1 3 (80: its fused pass carries five vectors; at
// 4 it ran 16% slower, cg 5% faster, PERF.md), double 2 (128).
template <typename T, int METHOD>
__host__ __device__ constexpr int blocks_per_sm() {
  return sizeof(T) == 8 ? HPCCG_DIA_BLOCKS_F64 : (METHOD == CG ? HPCCG_DIA_BLOCKS : HPCCG_DIA_BLOCKS_CG1);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) { return (uint32_t)__cvta_generic_to_shared(p); }

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar)) : "memory");
}

// Whether the phase of bar with this parity has completed.
__device__ __forceinline__ bool mbar_done(uint64_t* bar, unsigned parity) {
  unsigned ok;
  asm volatile(
      "{\n\t.reg .pred p;\n\tmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\tselp.u32 %0, 1, 0, p;\n}"
      : "=r"(ok)
      : "r"(smem_addr(bar)), "r"(parity)
      : "memory");
  return ok != 0;
}

__device__ __forceinline__ uint64_t evict_first() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(policy));
  return policy;
}

// One 1-D bulk copy of `bytes` (a multiple of 16; both addresses 16-byte
// aligned) from global into shared memory, completing on bar (one arrival
// that expects the bytes).
__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes, uint64_t* bar,
                                          uint64_t policy) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)), "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint [%0], [%1], %2, [%3], %4;" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar)), "l"(policy)
      : "memory");
}

template <typename T>
struct DiaParams {
  Common<T> c;
  const int* offsets;  // (ndiag,) increasing, shared by the ranks
  long long L;         // rows per rank
  int ndiag, bw_lo, bw_hi, width;
};

// One block's view of its rank of the banded matrix.
template <typename T, cuda::thread_scope Scope>
struct DiaRank : Comm<T, T, NT, Scope> {
  using Base = Comm<T, T, NT, Scope>;
  using W = typename Wide<T>::W;
  // V values a 16-byte word; R rows a thread (RV words); TILE rows a block
  static constexpr int V = 16 / (int)sizeof(T), R = R_ROWS, RV = R / V, TILE = NT * R;
  static constexpr bool FIXED_ITERS = FIXED;
  const int* s_off;
  T* ring;
  uint64_t* full;
  const int* offsets;
  int ndiag, bw_lo, bw_hi, width;
  unsigned long long ring_q = 0;  // segments through the ring so far

  __device__ DiaRank(const DiaParams<T>& p, T* red, int* s, T* ring_, uint64_t* full_)
      : Base(p.c, red, threadIdx.x, p.L), s_off(s), ring(ring_), full(full_) {
    offsets = p.offsets;
    ndiag = p.ndiag;
    bw_lo = p.bw_lo;
    bw_hi = p.bw_hi;
    width = p.width;
    for (int j = threadIdx.x; j < ndiag && j < OFF_CHUNK; j += NT) s[j] = offsets[j];
    if (threadIdx.x == 0) {
      for (int i = 0; i < NS; ++i) mbar_init(full + i);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
  }

  __device__ int offset(int j) const { return j < OFF_CHUNK ? s_off[j] : __ldg(offsets + j); }

  // This block's tiles, k = 0 .. tiles() - 1: the rank's tiles lb, lb +
  // bpr, ... (an even, contiguous share of the rank's rows for each block
  // ran 11-14% slower, PERF.md); tile k's rows [first(k), end(k)).
  __device__ int64_t tiles() const {
    const int64_t ntiles = (this->n + TILE - 1) / TILE;
    return this->lb < ntiles ? (ntiles - this->lb + this->bpr - 1) / this->bpr : 0;
  }
  __device__ int64_t first(int64_t k) const { return (this->lb + k * this->bpr) * (int64_t)TILE; }
  __device__ int64_t end(int64_t k) const {
    const int64_t e = first(k) + TILE;
    return e < this->n ? e : this->n;
  }

  // f(i, cnt) for the R rows i.. of each of this block's tiles that this
  // thread owns (cnt < R in a last, partial group). None in the split builds.
  template <typename F>
  __device__ void groups(F&& f) {
    if (FIXED) return;
    const int64_t nt = tiles();
    for (int64_t k = 0; k < nt; ++k) {
      const int64_t i = first(k) + (int64_t)this->tid * R, e = end(k);
      if (i < e) f(i, e - i < R ? (int)(e - i) : R);
    }
  }

  // v = p[i .. i + cnt) through L2, zero beyond; 16-byte loads where wide
  // and cnt == R.
  __device__ static void load(const T* p, int64_t i, int cnt, bool wide, T (&v)[R]) {
    if (wide && cnt == R) {
#pragma unroll
      for (int w = 0; w < RV; ++w) reinterpret_cast<W*>(v)[w] = __ldcg(reinterpret_cast<const W*>(p + i) + w);
      return;
    }
#pragma unroll
    for (int j = 0; j < R; ++j) v[j] = j < cnt ? __ldcg(p + i + j) : T(0);
  }

  // p[i .. i + cnt) = v, for a state vector (16-byte aligned at a group).
  __device__ static void store(T* p, int64_t i, int cnt, const T (&v)[R]) {
    if (cnt == R) {
#pragma unroll
      for (int w = 0; w < RV; ++w) reinterpret_cast<W*>(p + i)[w] = reinterpret_cast<const W*>(v)[w];
      return;
    }
#pragma unroll
    for (int j = 0; j < R; ++j) {
      if (j < cnt) p[i + j] = v[j];
    }
  }

  // Whether b and x0 of this rank take 16-byte loads.
  __device__ bool io_wide() const {
    return ((reinterpret_cast<uintptr_t>(this->template ptr<T>(P_B, this->rank)) |
             reinterpret_cast<uintptr_t>(this->template ptr<T>(P_X0, this->rank))) &
            15) == 0;
  }

  // Real row i of a vector goes to the neighbours' landing strips of phase
  // ph: the first bw_hi rows to the rank below, the last bw_lo to the rank
  // above.
  __device__ void push_one(int ph, int64_t i, T v) {
    const int rank = this->rank;
    if (i < bw_hi && rank > 0) this->template ptr<T>(P_H, rank - 1)[(int64_t)(2 * ph + 1) * width + i] = v;
    const int64_t above = this->n - bw_lo;  // the first row the rank above reads
    if (i >= above && rank < this->ndev - 1) {
      this->template ptr<T>(P_H, rank + 1)[(int64_t)2 * ph * width + (i - above)] = v;
    }
  }

  // The rows i .. i + cnt of a vector being produced, as push_one sends them.
  __device__ void push(int ph, int64_t i, int cnt, const T (&v)[R]) {
    if (i < bw_hi || i + cnt > this->n - bw_lo) {
#pragma unroll
      for (int j = 0; j < R; ++j) {
        if (j < cnt) push_one(ph, i + j, v[j]);
      }
    }
  }

  // The RV + 1 words of v from c - c % V on (v 16-byte aligned, all of them
  // inside the rank): the R values of x at rows c.. are e[s..s + R) with
  // s = c % V (select). Loads only, so that a step's gathers are in flight
  // together.
  __device__ static void gather(const T* v, int64_t c, T (&e)[R + V]) {
    const W* w = reinterpret_cast<const W*>(v + (c & ~(int64_t)(V - 1)));
#pragma unroll
    for (int k = 0; k <= RV; ++k) reinterpret_cast<W*>(e)[k] = w[k];
  }

  __device__ static void select(const T (&e)[R + V], int s, T (&x)[R]) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      T y = e[r];
#pragma unroll
      for (int k = 1; k < V; ++k) y = s == k ? e[r + k] : y;
      x[r] = y;
    }
  }

  // Segment u of this apply (tile lb + (u / ndiag) bpr, diagonal u %
  // ndiag) into its ring stage; thread 0 only.
  __device__ void issue(const T* data, int64_t u, uint64_t policy) {
    const int64_t n = this->n, k = u / ndiag, base = first(k);
    const int64_t j = u % ndiag;
    const int stage = (int)((ring_q + u) % NS);
    const unsigned bytes = (unsigned)((end(k) - base) * (int64_t)sizeof(T));
    bulk_load(ring + (int64_t)stage * TILE, data + j * n + base, bytes, full + stage, policy);
  }

  // Waits for ring item g (bounded: a copy that never lands is a fault).
  __device__ void ring_wait(unsigned long long g) {
    const int stage = (int)(g % NS);
    const unsigned parity = (unsigned)(g / NS) & 1u;
    if (!mbar_done(full + stage, parity)) {
      const unsigned long long t0 = globaltimer();
      while (!mbar_done(full + stage, parity)) {
        if (globaltimer() - t0 > RING_WAIT_NS) __trap();
      }
    }
  }

  // A v over the rank's rows, with phase ph's landing strips as the rows
  // below and above: emit(i, cnt, c, y) for each thread's R rows i.. of a
  // tile (cnt of them real), with c = v and y = A v there. The diagonals
  // go in steps of U: the step's x loads first, then its data and sums in
  // offset order, then (ring) a block barrier and the step's stages
  // refilled. Every thread of the block runs the same tiles and steps, so
  // all of them reach the ring's barriers.
  template <typename Emit>
  __device__ void apply(int kind, int ph, Emit&& emit) {
    if (SYNC_ONLY) return;
    const int64_t n = this->n;
    const int tid = this->tid;
    const T* v = this->vec(kind);
    const T* lo = this->template ptr<T>(P_H, this->rank) + (int64_t)2 * ph * width;
    const T* hi = lo + width;
    const T* data = this->template ptr<T>(P_DATA, this->rank);
    const bool staged = n % V == 0 && (reinterpret_cast<uintptr_t>(data) & 15) == 0;
    const int64_t nt = tiles();
    const int64_t items = nt * ndiag;
    const uint64_t policy = evict_first();
    if (staged && tid == 0) {
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // the last apply's reads of the ring
      for (int64_t u = 0; u < NS && u < items; ++u) issue(data, u, policy);
    }
    int64_t q = 0;
    for (int64_t k = 0; k < nt; ++k) {
      const int64_t base = first(k), stop = end(k), i0 = base + (int64_t)tid * R;
      // every row's reach, and a word of x past it, inside the rank
      const bool inner = base >= bw_lo && base + TILE + bw_hi + V <= n;
      T acc[R];
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = T(0);
      for (int j0 = 0; j0 < ndiag; j0 += U) {
        const int m = ndiag - j0 < U ? ndiag - j0 : U;
        T xv[U][R];
        if (inner) {
          T e[U][R + V];
          int sh[U];
#pragma unroll
          for (int u = 0; u < U; ++u) {
            // past the last diagonal: a copy of the step's first (not summed)
            const int64_t c = i0 + offset(u < m ? j0 + u : j0);
            sh[u] = (int)(c & (V - 1));
            gather(v, c, e[u]);
          }
#pragma unroll
          for (int u = 0; u < U; ++u) select(e[u], sh[u], xv[u]);
        } else {
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const int off = offset(u < m ? j0 + u : j0);
#pragma unroll
            for (int r = 0; r < R; ++r) {
              const int64_t c = i0 + r + off;
              xv[u][r] = i0 + r >= stop ? T(0) : (c < 0 ? lo[c + bw_lo] : (c >= n ? hi[c - n] : v[c]));
            }
          }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (u < m) {
            alignas(16) T d[R];
            const int64_t j = j0 + u;
            if (staged) {
              ring_wait(ring_q + q + u);
              const W* st = reinterpret_cast<const W*>(ring + (int64_t)((ring_q + q + u) % NS) * TILE);
#pragma unroll
              for (int w = 0; w < RV; ++w) reinterpret_cast<W*>(d)[w] = st[tid * RV + w];
            } else {
#pragma unroll
              for (int r = 0; r < R; ++r) d[r] = i0 + r < stop ? __ldcs(data + j * n + i0 + r) : T(0);
            }
#pragma unroll
            for (int r = 0; r < R; ++r) {
              if (inner || i0 + r < stop) acc[r] = add_rn(acc[r], mul_rn(d[r], xv[u][r]));
            }
          }
        }
        if (staged) {
          __syncthreads();  // the step's stages are read: refill them
          if (tid == 0) {
            asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
            for (int64_t u = q + NS; u < q + NS + m && u < items; ++u) issue(data, u, policy);
          }
        }
        q += m;
      }
      if (i0 < stop) {
        const int cnt = stop - i0 < R ? (int)(stop - i0) : R;
        alignas(16) T c[R];
        load(v, i0, cnt, true, c);
        emit(i0, cnt, c, acc);
      }
    }
    ring_q += items;
  }
};

// y = x + a v, each operation rounded on its own.
template <typename T>
__device__ __forceinline__ T axpy(T x, T a, T v) {
  return add_rn(x, mul_rn(a, v));
}

// Method cg: the reference recurrence (collective_kernel.py:_cg_whole_solve),
// exchanging p (phase 0 at the init, 1 in the loop); P_S holds A p. x +=
// alpha p is made in the next iteration's p pass (and at the exit).
template <class Rank>
__device__ void solve_cg(Rank& R) {
  using T = typename Rank::Store;
  constexpr int NR = Rank::R;  // rows a thread
  const T* b = R.template ptr<T>(P_B, R.rank);
  const T* x0 = R.template ptr<T>(P_X0, R.rank);
  T *X = R.vec(P_X), *Rv = R.vec(P_R), *Pv = R.vec(P_P), *AP = R.vec(P_S);
  const bool io = R.io_wide();
  // init: x = p = x0; r = b - A p; rtrans = r.r (slot 0)
  R.groups([&](int64_t i, int cnt) {
    alignas(16) T v[NR];
    Rank::load(x0, i, cnt, io, v);
    Rank::store(X, i, cnt, v);
    Rank::store(Pv, i, cnt, v);
    R.push(0, i, cnt, v);
  });
  HPCCG_TRY(R.exchange(0));
  T rr = T(0);
  R.apply(P_P, 0, [&](int64_t i, int cnt, const T(&)[NR], const T(&y)[NR]) {
    alignas(16) T bv[NR], r[NR];
    Rank::load(b, i, cnt, io, bv);
#pragma unroll
    for (int j = 0; j < NR; ++j) {
      r[j] = add_rn(bv[j], -y[j]);
      if (j < cnt) rr += r[j] * r[j];
    }
    Rank::store(Rv, i, cnt, r);
  });
  T rtrans, unused;
  HPCCG_TRY(R.allreduce(rr, T(0), 0, rtrans, unused));
  T normr = sqrt(rtrans), rtrans_old = rtrans, alpha = T(0);
  if (R.leader) R.P.trace[0] = normr;
  int k = 1;
  while (k < R.P.max_iter && (Rank::FIXED_ITERS || normr > R.P.tol)) {
    // allreduce 1: r.r (at k == 1 the init partials again: the same bits)
    HPCCG_TRY(R.allreduce(rr, T(0), 1, rtrans, unused));
    const T beta = k == 1 ? T(0) : rtrans / rtrans_old;
    normr = sqrt(rtrans);
    if (R.leader) R.P.trace[k] = normr;
    // the previous iteration's x += alpha p; p = r + beta p, pushed
    const bool fold = k > 1;
    R.groups([&](int64_t i, int cnt) {
      alignas(16) T rv[NR], pv[NR];
      Rank::load(Rv, i, cnt, true, rv);
      Rank::load(Pv, i, cnt, true, pv);
      if (fold) {
        alignas(16) T xv[NR];
        Rank::load(X, i, cnt, true, xv);
#pragma unroll
        for (int j = 0; j < NR; ++j) xv[j] = axpy(xv[j], alpha, pv[j]);
        Rank::store(X, i, cnt, xv);
      }
#pragma unroll
      for (int j = 0; j < NR; ++j) pv[j] = axpy(rv[j], beta, pv[j]);
      Rank::store(Pv, i, cnt, pv);
      R.push(1, i, cnt, pv);
    });
    HPCCG_TRY(R.exchange(1));
    T pap_blk = T(0), pap;
    R.apply(P_P, 1, [&](int64_t i, int cnt, const T(&c)[NR], const T(&y)[NR]) {
      Rank::store(AP, i, cnt, y);
#pragma unroll
      for (int j = 0; j < NR; ++j) {
        if (j < cnt) pap_blk += c[j] * y[j];
      }
    });
    // allreduce 2: p.Ap
    HPCCG_TRY(R.allreduce(pap_blk, T(0), 0, pap, unused));
    alpha = rtrans / pap;
    // r -= alpha Ap, the new r.r
    rr = T(0);
    R.groups([&](int64_t i, int cnt) {
      alignas(16) T rv[NR], av[NR];
      Rank::load(Rv, i, cnt, true, rv);
      Rank::load(AP, i, cnt, true, av);
#pragma unroll
      for (int j = 0; j < NR; ++j) {
        rv[j] = axpy(rv[j], -alpha, av[j]);
        if (j < cnt) rr += rv[j] * rv[j];
      }
      Rank::store(Rv, i, cnt, rv);
    });
    rtrans_old = rtrans;
    ++k;
  }
  if (k > 1) {  // the last iteration's x += alpha p
    R.groups([&](int64_t i, int cnt) {
      alignas(16) T xv[NR], pv[NR];
      Rank::load(X, i, cnt, true, xv);
      Rank::load(Pv, i, cnt, true, pv);
#pragma unroll
      for (int j = 0; j < NR; ++j) xv[j] = axpy(xv[j], alpha, pv[j]);
      Rank::store(X, i, cnt, xv);
    });
  }
  R.finish(normr, rtrans, k);
}

// Method cg1: Chronopoulos-Gear (collective_kernel.py:_cg1_whole_solve),
// exchanging x at the init (phase 0) and r in every iteration (phase 1);
// P_S = A p by recurrence, P_U = A r.
template <class Rank>
__device__ void solve_cg1(Rank& R) {
  using T = typename Rank::Store;
  constexpr int NR = Rank::R;  // rows a thread
  const T* b = R.template ptr<T>(P_B, R.rank);
  const T* x0 = R.template ptr<T>(P_X0, R.rank);
  T *X = R.vec(P_X), *Rv = R.vec(P_R), *Pv = R.vec(P_P), *Sv = R.vec(P_S), *U = R.vec(P_U);
  const bool io = R.io_wide();
  R.groups([&](int64_t i, int cnt) {
    alignas(16) T v[NR];
    Rank::load(x0, i, cnt, io, v);
    Rank::store(X, i, cnt, v);
    R.push(0, i, cnt, v);
  });
  HPCCG_TRY(R.exchange(0));
  R.apply(P_X, 0, [&](int64_t i, int cnt, const T(&)[NR], const T(&y)[NR]) {
    alignas(16) T bv[NR], r[NR];
    Rank::load(b, i, cnt, io, bv);
#pragma unroll
    for (int j = 0; j < NR; ++j) r[j] = add_rn(bv[j], -y[j]);
    Rank::store(Rv, i, cnt, r);
    R.push(1, i, cnt, r);
  });
  HPCCG_TRY(R.exchange(1));
  T g = T(0), d = T(0);
  auto apply_r = [&](int64_t i, int cnt, const T(&c)[NR], const T(&y)[NR]) {
    Rank::store(U, i, cnt, y);
#pragma unroll
    for (int j = 0; j < NR; ++j) {
      if (j < cnt) {
        g += c[j] * c[j];
        d += c[j] * y[j];
      }
    }
  };
  R.apply(P_R, 1, apply_r);
  T gamma, delta;
  HPCCG_TRY(R.allreduce(g, d, 0, gamma, delta));
  if (R.leader) R.P.trace[0] = sqrt(gamma);
  T alpha = gamma / delta, gamma_top = gamma, beta = T(0);
  int k = 1;
  while (k < R.P.max_iter && (Rank::FIXED_ITERS || sqrt(gamma_top) > R.P.tol)) {
    if (R.leader) R.P.trace[k] = sqrt(gamma);
    const bool first = k == 1;
    // the end of body k-1 (p = r + beta p, s = u + beta s) fused with the
    // start of body k (x += alpha p, r -= alpha s)
    R.groups([&](int64_t i, int cnt) {
      alignas(16) T rv[NR], uv[NR], pv[NR], sv[NR], xv[NR];
      Rank::load(Rv, i, cnt, true, rv);
      Rank::load(U, i, cnt, true, uv);
      if (first) {
#pragma unroll
        for (int j = 0; j < NR; ++j) pv[j] = rv[j], sv[j] = uv[j];
      } else {
        Rank::load(Pv, i, cnt, true, pv);
        Rank::load(Sv, i, cnt, true, sv);
#pragma unroll
        for (int j = 0; j < NR; ++j) {
          pv[j] = axpy(rv[j], beta, pv[j]);
          sv[j] = axpy(uv[j], beta, sv[j]);
        }
      }
      Rank::store(Pv, i, cnt, pv);
      Rank::store(Sv, i, cnt, sv);
      Rank::load(X, i, cnt, true, xv);
#pragma unroll
      for (int j = 0; j < NR; ++j) {
        xv[j] = axpy(xv[j], alpha, pv[j]);
        rv[j] = axpy(rv[j], -alpha, sv[j]);
      }
      Rank::store(X, i, cnt, xv);
      Rank::store(Rv, i, cnt, rv);
      R.push(1, i, cnt, rv);
    });
    HPCCG_TRY(R.exchange(1));
    g = T(0);
    d = T(0);
    R.apply(P_R, 1, apply_r);
    T g_new, dl;
    HPCCG_TRY(R.allreduce(g, d, k & 1, g_new, dl));
    beta = g_new / gamma;
    alpha = g_new / (dl - beta * g_new / alpha);
    gamma_top = gamma;
    gamma = g_new;
    ++k;
  }
  R.finish(sqrt(gamma_top), gamma_top, k);
}

template <typename T, int METHOD, cuda::thread_scope Scope>
__global__ void __launch_bounds__(NT, blocks_per_sm<T, METHOD>())
    collective_dia_kernel(const __grid_constant__ DiaParams<T> P) {
  extern __shared__ __align__(128) unsigned char ring_raw[];
  __shared__ T red[NT];
  __shared__ int s_off[OFF_CHUNK];
  __shared__ __align__(8) uint64_t full[NS];
  DiaRank<T, Scope> R(P, red, s_off, reinterpret_cast<T*>(ring_raw), full);
  if (METHOD == CG) {
    solve_cg(R);
  } else {
    solve_cg1(R);
  }
}

template <typename T>
const void* kernel_for(int method) {
  return method == CG ? (const void*)collective_dia_kernel<T, CG, SCOPE>
                      : (const void*)collective_dia_kernel<T, CG1, SCOPE>;
}

// Blocks of K17 (method) resident at once on the current device: min(the
// occupancy with the ring's shared memory, blocks_per_sm) x SMs. Returns a
// CUDA error code.
template <typename T>
int resident_blocks(int method, int* blocks) {
  if (method != CG && method != CG1) return (int)cudaErrorInvalidValue;
  const void* kernel = kernel_for<T>(method);
  int dev = 0, sms = 0, coop_ok = 0, per_sm = 0;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<T>());
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop_ok, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NT, smem_bytes<T>());
  if (err != cudaSuccess) return (int)err;
  if (!coop_ok || per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  const int bound = method == CG ? blocks_per_sm<T, CG>() : blocks_per_sm<T, CG1>();
  *blocks = (per_sm < bound ? per_sm : bound) * sms;
  return (int)cudaSuccess;
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
  return (int)cudaLaunchCooperativeKernel(kernel_for<T>(method), dim3(ndev * bpr), dim3(NT), args, smem_bytes<T>(),
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

// Rows of a tile (dtype 0 float32, 1 float64): NT threads x 16 bytes of
// rows. A rank's blocks take its rows in such tiles.
int hpccg_collective_dia_block_rows(int dtype) {
  return dtype == 0 ? DiaRank<float, SCOPE>::TILE : DiaRank<double, SCOPE>::TILE;
}

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
