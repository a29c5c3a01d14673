// The protocol of the collective whole-solve kernels K15/K16 (collective.cu,
// the z-stacked stencil) and K17 (collective_dia.cu, a banded explicit
// matrix). Each kernel's file holds its drivers: K15/K16's march the staged
// tile with per-plane dot products (their allreduce is
// Slab::reduce_start/reduce_finish, this protocol with the rank's row formed
// from per-plane partials); K17's cg and cg1 use Comm::allreduce.
//
// Ranks. The mesh is single-controller (parallel/mesh.py): one process
// drives every rank. A launch runs the ranks [rank0, rank0 + ranks) of one
// card: every rank of the mesh when they share the card (K15-K17), or, for
// K15/K16 across cards, the card's own ranks, one cooperative launch per
// card. The grid is ranks x bpr blocks, every block resident at once
// (cooperative launch: occupancy x SMs, else the launch is refused); block
// b serves rank rank0 + b / bpr. Ranks meet only through memory that a
// peer GPU can also write, through pointer tables that name every rank's
// buffers: no grid-wide sync, so the ranks are not in lockstep and the
// exchange protocol below is what orders them. Across cards each card's
// table holds the other cards' buffers at their peer (P2P, unified)
// addresses, so a push into a neighbour's landing buffer and a row of a
// peer's allreduce table are stores over NVLink into the reader's own
// memory, and the counters are atomics there. The kernels take the
// counters' scope as a template argument: the device's when every rank
// shares the card, the system's across cards.
//
// Protocol (JAX's phase and parity discipline, collective_kernel.py:22-32):
//   - rank barrier: a rank's blocks sync through an epoch counter in global
//     memory (release increments, acquire waits);
//   - halo: the pass that produces a vector also writes the rows its
//     neighbours read (the view's push: stencil planes, or DIA band strips)
//     into their landing buffers, then release-increments the neighbours'
//     arrival counter of that phase; a reader acquire-waits for bpr
//     arrivals per exchange from each neighbour. Each rank has up to five
//     phases of (from below, from above) landing buffers: K17's cg and cg1
//     use phase 0 for the init exchange and 1 for the loop (K15/K16's use
//     of them: collective.cu);
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
// the other blocks of the card see the word and leave too (a card's error
// word is its own: the other cards' blocks give up at their own waits). The
// wrappers (ops/cuda/collective.py) raise RuntimeError with it.
//
// Timers (CardPart::timers, null when off; system scope only): block 0 of
// each launched rank adds up on %globaltimer the time it spins on its peers
// (halo arrivals and allreduce table slots) and writes it, with the time
// from its start to its finish, into its rank's pair of the card's timers.
//
// A view of a rank (a struct deriving from Comm: K15/K16's Slab, K17's
// DiaRank) adds what depends on the operator: the pushes of a vector being
// produced into the neighbours' landing buffers, and the apply of A over
// the rank's rows with a phase's landing buffers as the halo.
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
// share: the device (every rank on one card) or the system (ranks on peer
// cards: K15/K16's multi-card launch).
template <cuda::thread_scope Scope>
using ScopedAtomic = cuda::atomic_ref<unsigned, Scope>;

template <cuda::thread_scope Scope>
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
// What a launch of one card's ranks among several cards adds to a rank's
// view (system scope only): the launch's first rank and its timers, per
// launched rank (ns waited on peers, ns of the kernel), null when off. At
// device scope it is empty, so the one-card kernels keep their layout.
template <cuda::thread_scope Scope>
struct CardPart {
  __device__ CardPart(int, unsigned long long*) {}
};

template <>
struct CardPart<cuda::thread_scope_system> {
  int rank0;
  unsigned long long* timers;
  __device__ CardPart(int r, unsigned long long* t) : rank0(r), timers(t) {}
};

template <typename T, typename S, int NT, cuda::thread_scope Scope>
struct Comm : CardPart<Scope> {
  using Store = T;
  using Scalar = S;
  const Common<S> P;
  S* red;
  int rank, lb, tid, ndev, bpr;
  int64_t n;
  unsigned bar_epoch = 0, nred = 0, halo_epoch[5] = {0, 0, 0, 0, 0}, uses[2] = {0, 0};
  unsigned pending = 0;  // the slot count an allreduce_finish waits for
  bool leader;

  // rank0, timers: a launch of one card's ranks across cards (CardPart)
  __device__ Comm(const Common<S>& p, S* r, int thread, int64_t rows, int rank0 = 0,
                  unsigned long long* timers = nullptr)
      : CardPart<Scope>(rank0, timers), P(p), red(r) {
    ndev = P.ndev;
    bpr = P.bpr;
    rank = blockIdx.x / bpr;
    if constexpr (Scope == cuda::thread_scope_system) rank += this->rank0;
    lb = blockIdx.x % bpr;
    tid = thread;
    n = rows;
    leader = rank == 0 && lb == 0 && tid == 0;
    if constexpr (Scope == cuda::thread_scope_system) {
      if (timing()) {
        clocks()[0] = globaltimer();
        clocks()[1] = 0;
      }
    }
  }

  // Thread 0 of the rank's block 0 while the timers are on: it keeps them.
  // Only the system-scope instances (ranks across cards) time; the
  // device-scope ones carry no timer code.
  __device__ bool timing() const {
    if constexpr (Scope == cuda::thread_scope_system) {
      return this->timers != nullptr && lb == 0 && tid == 0;
    } else {
      return false;
    }
  }
  // The timers' start and the ns spent waiting on peers, in shared memory,
  // so that the threads that do not keep them hold nothing for them.
  __device__ static unsigned long long* clocks() {
    __shared__ unsigned long long t[2];
    return t;
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
      if constexpr (Scope == cuda::thread_scope_system) {
        if (timing() && (site == SITE_TABLE || site >= SITE_HALO)) clocks()[1] += globaltimer() - t0;
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
    if constexpr (Scope == cuda::thread_scope_system) {
      if (timing()) {
        unsigned long long* t = this->timers + 2 * (rank - this->rank0);
        t[0] = clocks()[1];
        t[1] = globaltimer() - clocks()[0];
      }
    }
  }
};

#define HPCCG_TRY(cond) \
  if (!(cond)) return

}  // namespace coll
}  // namespace hpccg
