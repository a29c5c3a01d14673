// The protocol of the collective whole-solve kernels K15/K16 (collective.cu,
// the z-stacked stencil) and K17 (collective_dia.cu, a banded explicit
// matrix), and K17's two CG drivers. K15/K16 have drivers of their own on
// the staged tile, with per-plane dot products (collective.cu: their
// allreduce is Slab::reduce_start/reduce_finish, this protocol with the
// rank's row formed from per-plane partials).
//
// Ranks. The mesh is single-controller (parallel/mesh.py): every rank of
// the launch lives on this device. The grid is ndev x bpr blocks, every
// block resident at once (cooperative launch: occupancy x SMs, else the
// launch is refused); block b serves rank b / bpr. Ranks meet only through
// memory that a peer GPU could also write, through per-rank pointer tables:
// no grid-wide sync, so the ranks are not in lockstep and the exchange
// protocol below is what orders them. A multi-card launch would only fill
// the pointer tables with peer (P2P) addresses; it is not built yet
// (ROADMAP).
//
// Protocol (JAX's phase and parity discipline, collective_kernel.py:22-32):
//   - rank barrier: a rank's blocks sync through an epoch counter in global
//     memory (release increments, acquire waits);
//   - halo: the pass that produces a vector also writes the rows its
//     neighbours read (the view's push: stencil planes, or DIA band strips)
//     into their landing buffers, then release-increments the neighbours'
//     arrival counter of that phase; a reader acquire-waits for bpr
//     arrivals per exchange from each neighbour. Each rank has up to five
//     phases of (from below, from above) landing buffers: the cg and cg1
//     drivers here use phase 0 for the init exchange and 1 for the loop
//     (K15/K16's use of them: collective.cu);
//   - allreduce: each block writes its partials, release-increments its
//     rank's counter; block 0 of the rank waits for all, sums them in a
//     fixed tree, writes the rank's row into the slot's table of every
//     peer and release-increments each peer's slot counter; every block
//     waits for ndev rows and sums them in rank order. Slots alternate by
//     parity, so a fast rank's next row never lands in a round a slow rank
//     is still summing. The drivers' single-buffered phase 1 is safe
//     because a rank pushes into it again only after an allreduce that
//     needs the reader's row, which the reader writes after it read the
//     landing buffers. An allreduce is also a barrier of the rank's blocks:
//     a block leaves it only after block 0 of its rank saw every block's
//     partials.
// Uniform scalars: every block of every rank sums the same rows in the same
// order, so all hold bit-identical alpha, beta and gamma and take the same
// exit decision; two solves are bit-identical (no float atomics).
//
// Bounded waits: every spin-wait gives up after wait_ns of %globaltimer,
// writes an error word (site, rank, expected count), and the block leaves;
// the other blocks see the word and leave too. The wrappers
// (ops/cuda/collective.py) raise RuntimeError with it.
//
// A view of a rank for the drivers here (a struct deriving from Comm, K17's
// DiaRank) adds what depends on the operator: push(ph, i, v), which sends
// real element i of a vector being produced to the neighbours' landing
// buffers of phase ph, and apply(kind, ph, emit), which computes A v over
// the rank's rows with phase ph's landing buffers as the halo and calls
// emit(i, v[i], (A v)[i]).
//
// Storage and compute (storage.cuh): the vectors and the landing buffers
// are T, the arithmetic, the partials, the allreduce table, the scalars, the
// trace and the stats S (K15/K16's per-plane partials: double). T = S for
// float and double; bfloat16 vectors (K15/K16 only) compute in float. A
// value is rounded to T where it is stored, and the pass that stores it
// goes on with the stored value (a
// pushed halo row, r in r.r, p in x += alpha p), so that a plain torch
// recurrence that stores every vector rounds at the same places; the dots
// of an apply take the unrounded S result (p.Ap, r.u, w.r), as K5 does.

#pragma once

#include <cuda/atomic>
#include <cuda_runtime.h>
#include <stdint.h>

#include "reduce.cuh"
#include "storage.cuh"

namespace hpccg {
namespace coll {

enum Method { CG = 0, CG1 = 1, PIPECG = 2 };
// rows of the pointer table (NKIND x ndev addresses); the same numbers as
// ops/cuda/collective.py. P_DATA is K17's diagonal data, P_V K16's second w.
enum { P_B, P_X0, P_X, P_R, P_P, P_S, P_U, P_Z, P_Q, P_H, P_PARTS, P_TABLE, P_CTR, P_DATA, P_V, NKIND };
// a rank's counters: halo arrivals [phase][from below, from above], the
// rank barrier, the partials' arrivals, the two allreduce slots
enum { C_HALO = 0, C_BAR = 10, C_RANK = 11, C_TABLE = 12, NCTR = 16 };
// error word: [set, site, rank, expected count]; the site of a halo wait is
// SITE_HALO + 2 * phase + direction
enum { SITE_BAR = 1, SITE_RANK = 2, SITE_TABLE = 3, SITE_HALO = 16 };

// The launch parameters every collective kernel takes (S: the compute type).
template <typename S>
struct Common {
  const long long* ptrs;
  S* trace;
  S* stats;
  int* err;
  int ndev, bpr, max_iter;
  S tol;
  unsigned long long wait_ns;
};

__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// The counters' atomics and fences have the scope of the memory the ranks
// share: the system (peer cards; the default, K17's) or the device (every
// rank of the launch on one card: K15/K16).
template <cuda::thread_scope Scope>
using ScopedAtomic = cuda::atomic_ref<unsigned, Scope>;

template <cuda::thread_scope Scope = cuda::thread_scope_system>
__device__ __forceinline__ void release_add(unsigned* c) {
  ScopedAtomic<Scope>(*c).fetch_add(1u, cuda::memory_order_release);
}

template <cuda::thread_scope Scope>
__device__ __forceinline__ void scope_fence() {
  if constexpr (Scope == cuda::thread_scope_system) {
    __threadfence_system();
  } else {
    __threadfence();
  }
}

__host__ __device__ __forceinline__ int ceil_div(int a, int b) { return (a + b - 1) / b; }

// One block's view of its rank and the protocol; NT threads per block, n
// real elements per rank; vectors stored in T, computed in S; the counters
// at memory scope Scope.
template <typename T, typename S, int NT, cuda::thread_scope Scope = cuda::thread_scope_system>
struct Comm {
  using Store = T;
  using Scalar = S;
  const Common<S> P;
  S* red;
  int rank, lb, tid, ndev, bpr;
  int64_t n;
  unsigned bar_epoch = 0, nred = 0, halo_epoch[5] = {0, 0, 0, 0, 0}, uses[2] = {0, 0};
  unsigned pending = 0;  // the slot count an allreduce_finish waits for
  bool leader;

  __device__ Comm(const Common<S>& p, S* r, int thread, int64_t rows) : P(p), red(r) {
    ndev = P.ndev;
    bpr = P.bpr;
    rank = blockIdx.x / bpr;
    lb = blockIdx.x % bpr;
    tid = thread;
    n = rows;
    leader = rank == 0 && lb == 0 && tid == 0;
  }

  template <typename V>
  __device__ V* ptr(int kind, int r) const {
    return reinterpret_cast<V*>(P.ptrs[kind * ndev + r]);
  }
  __device__ unsigned* ctr(int r) const { return ptr<unsigned>(P_CTR, r); }
  // rank's vector of `kind`
  __device__ T* vec(int kind) const { return ptr<T>(kind, rank); }

  __device__ S bsum(S v) {
    const S t = hpccg::block_sum<S, NT>(v, red, tid);
    __syncthreads();  // every thread has read red[0] before red is reused
    return t;
  }

  // Thread 0 acquire-waits until *c >= target, or gives up after wait_ns
  // (or when another block gave up); every thread gets the outcome.
  __device__ bool wait(unsigned* c, unsigned target, int site) {
    __shared__ int ok;
    if (tid == 0) {
      cuda::atomic_ref<int, cuda::thread_scope_system> e(P.err[0]);
      int res = 1;
      const unsigned long long t0 = globaltimer();
      while (ScopedAtomic<Scope>(*c).load(cuda::memory_order_acquire) < target) {
        if (e.load(cuda::memory_order_relaxed) != 0) {
          res = 0;
          break;
        }
        if (globaltimer() - t0 > P.wait_ns) {
          int expect = 0;
          if (e.compare_exchange_strong(expect, 1, cuda::memory_order_relaxed)) {
            P.err[1] = site;
            P.err[2] = rank;
            P.err[3] = (int)target;
          }
          res = 0;
          break;
        }
      }
      __threadfence();
      ok = res;
    }
    __syncthreads();
    const bool r = ok != 0;
    __syncthreads();  // ok is reused by the next wait
    return r;
  }

  // Every thread's writes of this block are done: thread 0 publishes them.
  __device__ void publish() {
    __syncthreads();
    if (tid == 0) scope_fence<Scope>();
  }

  // Halo exchange of phase ph after the pass that pushed its rows: the
  // rank barrier, then bpr arrivals from each neighbour.
  __device__ bool exchange(int ph) {
    publish();
    if (tid == 0) {
      release_add<Scope>(ctr(rank) + C_BAR);
      if (rank > 0) release_add<Scope>(ctr(rank - 1) + C_HALO + 2 * ph + 1);  // I am its above
      if (rank < ndev - 1) release_add<Scope>(ctr(rank + 1) + C_HALO + 2 * ph);
    }
    if (!wait(ctr(rank) + C_BAR, ++bar_epoch * bpr, SITE_BAR)) return false;
    const unsigned target = ++halo_epoch[ph] * bpr;
    if (rank > 0 && !wait(ctr(rank) + C_HALO + 2 * ph, target, SITE_HALO + 2 * ph)) return false;
    if (rank < ndev - 1 && !wait(ctr(rank) + C_HALO + 2 * ph + 1, target, SITE_HALO + 2 * ph + 1)) {
      return false;
    }
    return true;
  }

  // f(i) for each real element i of the rank this block takes.
  template <typename F>
  __device__ void each(F&& f) {
    const int64_t stride = (int64_t)bpr * NT;
    for (int64_t i = (int64_t)lb * NT + tid; i < n; i += stride) f(i);
  }

  // The first half of an allreduce of (a, b) over the ranks in `slot`:
  // this block's partials, and (block 0 of the rank) the rank's row in
  // every peer's table.
  __device__ bool allreduce_start(S a, S b, int slot) {
    const S sa = bsum(a), sb = bsum(b);
    S* parts = ptr<S>(P_PARTS, rank);
    if (tid == 0) {
      parts[2 * lb] = sa;
      parts[2 * lb + 1] = sb;
    }
    publish();
    if (tid == 0) release_add<Scope>(ctr(rank) + C_RANK);
    ++nred;
    pending = ++uses[slot] * ndev;
    if (lb != 0) return true;
    if (!wait(ctr(rank) + C_RANK, nred * bpr, SITE_RANK)) return false;
    S pa = S(0), pb = S(0);
    for (int j = tid; j < bpr; j += NT) {
      pa += __ldcg(parts + 2 * j);
      pb += __ldcg(parts + 2 * j + 1);
    }
    pa = bsum(pa);
    pb = bsum(pb);
    if (tid == 0) {
      for (int peer = 0; peer < ndev; ++peer) {
        S* row = ptr<S>(P_TABLE, peer) + ((int64_t)slot * ndev + rank) * 2;
        row[0] = pa;
        row[1] = pb;
      }
      scope_fence<Scope>();
      for (int peer = 0; peer < ndev; ++peer) release_add<Scope>(ctr(peer) + C_TABLE + slot);
    }
    return true;
  }

  // The second half: wait for the ndev rows of `slot` and sum them in rank
  // order (the same bits in every block).
  __device__ bool allreduce_finish(int slot, S& a, S& b) {
    if (!wait(ctr(rank) + C_TABLE + slot, pending, SITE_TABLE)) return false;
    __shared__ S tot[2];
    if (tid == 0) {
      const S* tab = ptr<S>(P_TABLE, rank) + (int64_t)slot * ndev * 2;
      S sa = __ldcg(tab), sb = __ldcg(tab + 1);
      for (int r = 1; r < ndev; ++r) {
        sa += __ldcg(tab + 2 * r);
        sb += __ldcg(tab + 2 * r + 1);
      }
      tot[0] = sa;
      tot[1] = sb;
    }
    __syncthreads();
    a = tot[0];
    b = tot[1];
    __syncthreads();
    return true;
  }

  __device__ bool allreduce(S a, S b, int slot, S& ga, S& gb) {
    return allreduce_start(a, b, slot) && allreduce_finish(slot, ga, gb);
  }

  __device__ void finish(S normr, S rtrans, int k) {
    if (leader) {
      P.stats[0] = normr;
      P.stats[1] = rtrans;
      P.stats[2] = S(k - 1);
      P.stats[3] = S(0);
    }
  }
};

#define HPCCG_TRY(cond) \
  if (!(cond)) return

// Method cg: the reference recurrence (collective_kernel.py:_cg_whole_solve),
// exchanging p (phase 0 at the init, 1 in the loop); P_S holds A p.
template <class Rank>
__device__ void solve_cg(Rank& R) {
  using T = typename Rank::Store;
  using S = typename Rank::Scalar;
  const T* b = R.template ptr<T>(P_B, R.rank);
  const T* x0 = R.template ptr<T>(P_X0, R.rank);
  T *X = R.vec(P_X), *Rv = R.vec(P_R), *Pv = R.vec(P_P), *AP = R.vec(P_S);
  // init: x = p = x0; r = b - A p; rtrans = r.r (slot 0)
  R.each([&](int64_t i) {
    const T v = x0[i];
    X[i] = v;
    Pv[i] = v;
    R.push(0, i, v);
  });
  HPCCG_TRY(R.exchange(0));
  S rr = S(0);
  R.apply(P_P, 0, [&](int64_t i, S, S y) {
    const T r = from_s<T>(to_s(b[i]) - y);
    Rv[i] = r;
    const S rs = to_s(r);
    rr += rs * rs;
  });
  S rtrans, unused;
  HPCCG_TRY(R.allreduce(rr, S(0), 0, rtrans, unused));
  S normr = sqrt(rtrans), rtrans_old = rtrans;
  if (R.leader) R.P.trace[0] = normr;
  int k = 1;
  while (k < R.P.max_iter && normr > R.P.tol) {
    // allreduce 1: r.r (at k == 1 the init partials again: the same bits)
    HPCCG_TRY(R.allreduce(rr, S(0), 1, rtrans, unused));
    const S beta = k == 1 ? S(0) : rtrans / rtrans_old;
    normr = sqrt(rtrans);
    if (R.leader) R.P.trace[k] = normr;
    R.each([&](int64_t i) {
      const T p = from_s<T>(to_s(__ldcg(Rv + i)) + beta * to_s(__ldcg(Pv + i)));
      Pv[i] = p;
      R.push(1, i, p);
    });
    HPCCG_TRY(R.exchange(1));
    S pap_blk = S(0), pap;
    R.apply(P_P, 1, [&](int64_t i, S c, S y) {
      AP[i] = from_s<T>(y);
      pap_blk += c * y;
    });
    // allreduce 2: p.Ap
    HPCCG_TRY(R.allreduce(pap_blk, S(0), 0, pap, unused));
    const S alpha = rtrans / pap;
    rr = S(0);
    R.each([&](int64_t i) {
      X[i] = from_s<T>(to_s(__ldcg(X + i)) + alpha * to_s(__ldcg(Pv + i)));
      const T r = from_s<T>(to_s(__ldcg(Rv + i)) - alpha * to_s(__ldcg(AP + i)));
      Rv[i] = r;
      const S rs = to_s(r);
      rr += rs * rs;
    });
    rtrans_old = rtrans;
    ++k;
  }
  R.finish(normr, rtrans, k);
}

// Method cg1: Chronopoulos-Gear (collective_kernel.py:_cg1_whole_solve),
// exchanging x at the init (phase 0) and r in every iteration (phase 1);
// P_S = A p by recurrence, P_U = A r.
template <class Rank>
__device__ void solve_cg1(Rank& R) {
  using T = typename Rank::Store;
  using S = typename Rank::Scalar;
  const T* b = R.template ptr<T>(P_B, R.rank);
  const T* x0 = R.template ptr<T>(P_X0, R.rank);
  T *X = R.vec(P_X), *Rv = R.vec(P_R), *Pv = R.vec(P_P), *Sv = R.vec(P_S), *U = R.vec(P_U);
  R.each([&](int64_t i) {
    const T v = x0[i];
    X[i] = v;
    R.push(0, i, v);
  });
  HPCCG_TRY(R.exchange(0));
  R.apply(P_X, 0, [&](int64_t i, S, S y) {
    const T r = from_s<T>(to_s(b[i]) - y);
    Rv[i] = r;
    R.push(1, i, r);
  });
  HPCCG_TRY(R.exchange(1));
  S g = S(0), d = S(0);
  R.apply(P_R, 1, [&](int64_t i, S c, S y) {
    U[i] = from_s<T>(y);
    g += c * c;
    d += c * y;
  });
  S gamma, delta;
  HPCCG_TRY(R.allreduce(g, d, 0, gamma, delta));
  if (R.leader) R.P.trace[0] = sqrt(gamma);
  S alpha = gamma / delta, gamma_top = gamma, beta = S(0);
  int k = 1;
  while (k < R.P.max_iter && sqrt(gamma_top) > R.P.tol) {
    if (R.leader) R.P.trace[k] = sqrt(gamma);
    const bool first = k == 1;
    // the end of body k-1 (p = r + beta p, s = u + beta s) fused with the
    // start of body k (x += alpha p, r -= alpha s)
    R.each([&](int64_t i) {
      const S rv = to_s(__ldcg(Rv + i)), uv = to_s(__ldcg(U + i));
      const T p = from_s<T>(first ? rv : rv + beta * to_s(__ldcg(Pv + i)));
      const T s = from_s<T>(first ? uv : uv + beta * to_s(__ldcg(Sv + i)));
      Pv[i] = p;
      Sv[i] = s;
      X[i] = from_s<T>(to_s(__ldcg(X + i)) + alpha * to_s(p));
      const T r = from_s<T>(rv - alpha * to_s(s));
      Rv[i] = r;
      R.push(1, i, r);
    });
    HPCCG_TRY(R.exchange(1));
    g = S(0);
    d = S(0);
    R.apply(P_R, 1, [&](int64_t i, S c, S y) {
      U[i] = from_s<T>(y);
      g += c * c;
      d += c * y;
    });
    S g_new, dl;
    HPCCG_TRY(R.allreduce(g, d, k & 1, g_new, dl));
    beta = g_new / gamma;
    alpha = g_new / (dl - beta * g_new / alpha);
    gamma_top = gamma;
    gamma = g_new;
    ++k;
  }
  R.finish(sqrt(gamma_top), gamma_top, k);
}

// Blocks of `kernel` (NT threads) resident at once on the current device
// (occupancy x SMs). Returns a CUDA error code.
inline int occupancy_blocks(const void* kernel, int nt, int* blocks) {
  int dev = 0, sms = 0, coop_ok = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop_ok, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, nt, 0);
  if (err != cudaSuccess) return (int)err;
  if (!coop_ok || per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  *blocks = per_sm * sms;
  return (int)cudaSuccess;
}

}  // namespace coll
}  // namespace hpccg
