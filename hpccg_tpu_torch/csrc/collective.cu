// Collective whole-solve CG kernels for Hopper (sm_90a): K15 and K16 of the
// port.
//
// Replaces the TPU kernels
//   hpccg_tpu/ops/pallas/collective_kernel.py:_kernel (:329), with its
//     drivers _cg_whole_solve (:246) and _cg1_whole_solve (:160)
//     (K15: METHOD = CG, the reference recurrence with two allreduces per
//     iteration, or CG1, Chronopoulos-Gear with one)
//   hpccg_tpu/ops/pallas/collective_kernel.py:_kernel_pipelined (:596)
//     (K16: METHOD = PIPECG, Ghysels-Vanroose, the allreduce in flight while
//     the stencil applies)
// Each runs the whole multi-rank solve in one launch: the halo planes and
// the allreduce travel through memory inside the kernel, and the host reads
// the result back once. Instances: float, double, and bfloat16 vectors
// computed in float (storage.cuh; the JAX kernels run bfloat16 too, with
// the allreduce rows in bf16, collective_kernel.py:562, :842).
//
// The ranks, the protocol (rank barriers, halo phases, the allreduce table,
// parity slots), the bounded waits and the error word are K17's too and
// live in collective.cuh. This file holds the stencil's view of a rank
// (Slab), the three drivers and the entry points.
//
// What bounds it on this card. cg moves about 11 vector passes an
// iteration (K5: 10): 4 x 100^3 f32 is ~176 MB, ~53 us at 3.35 TB/s; at
// 1 x 100^3 the state sits in the 50 MB L2, and the protocol's serial hops
// (a rank's blocks -> block 0 of the rank -> every peer's table -> every
// block, per allreduce) weigh as K5's grid syncs do: measured apart with
// the sync-only build, 40% of cg's iteration there (PERF.md). Its first
// form marched one 4-byte load per thread and staged element with one
// plane in flight and two barriers a plane, ran its elementwise passes as
// grid-stride loops that ignored the tiles, summed the dots in block trees,
// and took 2.2x K5's time at 1 x 100^3 (PERF.md).
//
// What the design does about it:
//   - Every apply marches K5's staged tile (stencil_stage.cuh) with L2 =
//     true: 16 bytes of a row a thread, a tile of 32 V x TY points, the
//     z-planes staged by cp.async in a ring with one barrier a plane. The
//     staged input is a rank's vector with the landing planes of a phase as
//     its planes -1 and nz (null at the domain's ends, as K5's are). init
//     stages x0 with the peers' x0 planes, read through the pointer table:
//     x0 is an input, so no exchange precedes it.
//   - The work items are K5's: (x-tile, y-tile, z-chunk) triples of the
//     rank's slab, the z chunk the one of COLL_ZC, COLL_ZC/2, ..., 1 whose
//     busiest block stages the fewest planes, which the rank's blocks take
//     in turns in a fixed order. The elementwise passes run on the same
//     items' rows, plane by plane, a thread's V points on one 16-byte
//     access (or two of 8 bytes, ...: the launch's width; load_vec,
//     store_vec): a block's pass reads what the same block wrote in the
//     apply, so only an apply needs the rank's other blocks done. A pass
//     that writes a boundary plane also pushes it into the neighbour's
//     landing plane with the same stores. Every update is rounded one
//     operation at a time (no FMA contraction), so that the plain versions
//     round at the same places.
//   - The dot products have the TPU kernels' per-slab form with one-plane
//     slabs, as K5's: each (tile, plane) gets a double partial (each
//     product rounded to S, the warps' partials added in a fixed order) in
//     the rank's P_PARTS buffer of the round's parity; block 0 of the rank,
//     once the rank's partials have arrived, adds each plane's tiles in
//     tile order in double, rounds the plane sum to S once and adds the
//     plane sums in S in z order: the rank's row of the allreduce table.
//     Every block adds the ndev rows in rank order, as before. The plain
//     bf16 version (ops/cuda/collective.py) computes the same. At one rank
//     cg's dots (ONE_RANK) are formed by every block itself once the
//     partials have arrived and the table round is skipped: the same bits,
//     one hop less.
//   - The protocol's hops are its cost at these sizes, so each is paid once:
//     every rank of a launch shares this card, so the counters' atomics and
//     fences take device scope, not the system's (K17's; a multi-card
//     launch would take the system's again); a rank's row goes to its peers
//     behind one fence; pipecg double-buffers w, so that its exchange is
//     the allreduce's start and no barrier follows its apply.
//   - Everything other blocks or ranks wrote in the launch is read through
//     L2 (cp.async.cg, __ldcg), never through a possibly stale L1 line.
//
// COLL_ZC and the blocks per SM (HPCCG_COLL_BLOCKS for cg and cg1,
// HPCCG_COLL_BLOCKS_PIPE for pipecg: the launch bound) are compile-time
// constants, as is ONE_RANK; each can be set with a -D define of its
// HPCCG_COLL_* name and was chosen by measurement on an H100
// (scripts/collective_sweep.py, PERF.md). HPCCG_COLL_SYNC_ONLY=1 builds a variant whose passes do no
// vector work (the protocol's barriers, exchanges and allreduces with their
// partial sums alone, max_iter iterations whatever the residual), to time
// that fixed cost; only that script sets it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "cg_update.cuh"
#include "collective.cuh"
#include "reduce.cuh"
#include "stencil_stage.cuh"
#include "storage.cuh"

#ifndef HPCCG_COLL_ZC
#define HPCCG_COLL_ZC 32
#endif
#ifndef HPCCG_COLL_BLOCKS
#define HPCCG_COLL_BLOCKS 3
#endif
#ifndef HPCCG_COLL_BLOCKS_PIPE
#define HPCCG_COLL_BLOCKS_PIPE 2
#endif
#ifndef HPCCG_COLL_ONE_RANK
#define HPCCG_COLL_ONE_RANK 1
#endif
#ifndef HPCCG_COLL_SYNC_ONLY
#define HPCCG_COLL_SYNC_ONLY 0
#endif

namespace {

using namespace hpccg;
using namespace hpccg::coll;
using namespace hpccg::stage;

constexpr int COLL_ZC = HPCCG_COLL_ZC;  // z-planes per work item, at most
constexpr bool ONE_RANK = HPCCG_COLL_ONE_RANK != 0;
constexpr bool SYNC_ONLY = HPCCG_COLL_SYNC_ONLY != 0;
constexpr int COLL_SMEM = ring_bytes(1);  // the ring: one staged input
static_assert(COLL_ZC >= 1 && HPCCG_COLL_BLOCKS >= 1 && HPCCG_COLL_BLOCKS_PIPE >= 1, "collective constants");
// every rank of a launch shares this card: the protocol's atomics and
// fences at device scope (a multi-card launch would take the system's)
constexpr cuda::thread_scope SCOPE = cuda::thread_scope_device;

// Resident blocks per SM, at most (the kernel's launch bound): pipecg,
// whose passes carry seven vectors, gets more registers.
template <int METHOD>
__host__ __device__ constexpr int coll_blocks() {
  return METHOD == PIPECG ? HPCCG_COLL_BLOCKS_PIPE : HPCCG_COLL_BLOCKS;
}

template <typename S>
struct Params {
  Common<S> c;
  int nx, ny, nz;
  int zc;            // z-planes per work item
  int access;        // bytes per access of the state vectors and the landing planes
  int init_access;   // the same, of b and x0 too
  long long pitch;   // elements from one landing plane to the next
};

// A thread's V points of one output row: the offset of the first, how many
// lie inside the grid (<= 0: none), and the bytes of each access that loads
// or stores them: the launch's access width where all V lie inside the
// grid, else 0 (one element at a time).
struct Row {
  int64_t o;
  int count;
  int access;
};

// The V points of a row as 16 / sizeof(W) accesses of W, through L2.
template <typename W, typename T>
__device__ __forceinline__ void load_as(const T* p, T* v) {
#pragma unroll
  for (int i = 0; i < 16 / (int)sizeof(W); ++i) reinterpret_cast<W*>(v)[i] = __ldcg(reinterpret_cast<const W*>(p) + i);
}

template <typename W, typename T>
__device__ __forceinline__ void store_as(T* p, const T* v) {
#pragma unroll
  for (int i = 0; i < 16 / (int)sizeof(W); ++i) reinterpret_cast<W*>(p)[i] = reinterpret_cast<const W*>(v)[i];
}

// The thread's V points of a vector at `at`, as T (zero past the grid).
template <typename T>
__device__ __forceinline__ void load_vec(const T* p, const Row& at, T (&v)[Geo<T>::V]) {
  constexpr int V = Geo<T>::V;
  p += at.o;
  if (at.access == 16) {
    load_as<uint4>(p, v);
  } else if (at.access == 8) {
    load_as<uint2>(p, v);
  } else if (at.access == 4) {
    load_as<unsigned>(p, v);
  } else {
    *reinterpret_cast<uint4*>(v) = make_uint4(0, 0, 0, 0);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      if (j < at.count) v[j] = ldcg(p + j);
    }
  }
}

// The thread's points of a row inside the grid, from v.
template <typename T>
__device__ __forceinline__ void store_vec(T* p, const Row& at, const T (&v)[Geo<T>::V]) {
  constexpr int V = Geo<T>::V;
  p += at.o;
  if (at.access == 16) {
    store_as<uint4>(p, v);
  } else if (at.access == 8) {
    store_as<uint2>(p, v);
  } else if (at.access == 4) {
    store_as<unsigned>(p, v);
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      if (j < at.count) p[j] = v[j];
    }
  }
}

// One block's view of its rank of the z-stacked stencil problem: the
// rank's vectors and landing planes in T, the arithmetic in S; the dots'
// partials in double.
template <typename T, typename S, int STENCIL>
struct Slab : Comm<T, S, NT, SCOPE> {
  using Base = Comm<T, S, NT, SCOPE>;
  static constexpr int V = Geo<T>::V, TX = Geo<T>::TX;
  T* ring;
  double (*wred)[TY][COLL_ZC];  // [dot][warp][plane of the item]
  S* sums;                      // NT plane sums
  Extent ext, ext0;
  int nx, ny, nz, zc, tiles_x, tiles, items, lane, w;
  int64_t plane, pitch;
  S own[2];    // the rank's values of the last allreduce (ONE_RANK)
  bool local;  // the last allreduce skipped the table round

  __device__ Slab(const Params<S>& p, T* ring_, double (*wred_)[TY][COLL_ZC], S* sums_)
      : Base(p.c, sums_, threadIdx.x, (int64_t)p.nx * p.ny * p.nz),
        ring(ring_),
        wred(wred_),
        sums(sums_),
        ext{p.nx, p.ny, p.nz, p.access},
        ext0{p.nx, p.ny, p.nz, p.init_access} {
    nx = p.nx;
    ny = p.ny;
    nz = p.nz;
    zc = p.zc;
    tiles_x = ceil_div(nx, TX);
    tiles = tiles_x * ceil_div(ny, TY);
    items = tiles * ceil_div(nz, zc);
    lane = threadIdx.x & 31;
    w = threadIdx.x >> 5;
    plane = (int64_t)nx * ny;
    pitch = p.pitch;
  }

  __device__ const T* input(int kind) const { return this->template ptr<T>(kind, this->rank); }

  // Rank r's landing plane of phase ph: side 0 from below, 1 from above.
  __device__ T* landing(int r, int ph, int side) const {
    return this->template ptr<T>(P_H, r) + (2 * ph + side) * pitch;
  }

  // The rank's vector v with phase ph's landing planes as its planes -1 and
  // nz (null at the domain's ends).
  __device__ Planes<T> halo(const T* v, int ph) const {
    return {v, this->rank > 0 ? landing(this->rank, ph, 0) : nullptr,
            this->rank < this->ndev - 1 ? landing(this->rank, ph, 1) : nullptr};
  }

  // x0 with the peers' x0 planes next to it.
  __device__ Planes<T> x0_halo() const {
    const int r = this->rank;
    return {input(P_X0), r > 0 ? this->template ptr<T>(P_X0, r - 1) + (nz - 1) * plane : nullptr,
            r < this->ndev - 1 ? this->template ptr<T>(P_X0, r + 1) : nullptr};
  }

  // The thread's points on output plane z of the tile at (bx0, by0), for
  // accesses of `access` bytes.
  __device__ Row pts(int bx0, int by0, int z, int access) const {
    const int ix0 = bx0 + lane * V, iy = by0 + w;
    const int count = iy < ny ? min(V, nx - ix0) : 0;
    return Row{(int64_t)z * plane + (int64_t)iy * nx + ix0, count, count == V ? access : 0};
  }

  // The thread's points v (at `at`, on plane z) of a vector being produced
  // go to the neighbours' landing planes of phase ph where z is a boundary
  // plane: plane 0 to the rank below's "from above", plane nz-1 to the rank
  // above's "from below".
  __device__ void push(int ph, int z, const Row& at, const T (&v)[V]) {
    const int r = this->rank;
    const Row in{at.o - (int64_t)z * plane, at.count, at.access};
    if (z == 0 && r > 0) store_vec<T>(landing(r - 1, ph, 1), in, v);
    if (z == nz - 1 && r < this->ndev - 1) store_vec<T>(landing(r + 1, ph, 0), in, v);
  }

  // The rank's partials of the round after `done` allreduces: two dots of
  // tiles x nz (tile, plane) partials, double-buffered by parity.
  __device__ double* round_parts(unsigned done) const {
    return this->template ptr<double>(P_PARTS, this->rank) + (int64_t)(done & 1) * 2 * tiles * nz;
  }

  // Warp w's partial of dot d on plane z (of the item's planes from z0):
  // every lane calls it with its own sum.
  __device__ void plane_part(int d, int z, int z0, double v) {
    v = warp_sum(v);
    if (lane == 0) wred[d][w][z - z0] = v;
  }

  // body(bx0, by0, z0, z1) for each of this block's work items, in a fixed
  // order; after each, the item's (tile, plane) partials of NDOT dots (the
  // warps added in order) go to this round's buffer.
  template <int NDOT, typename Body>
  __device__ void for_items(Body&& body) {
    double* part = round_parts(this->nred);
    for (int it = this->lb; it < items; it += this->bpr) {
      const int cz = it / tiles, tile = it % tiles;
      const int z0 = cz * zc, z1 = min(z0 + zc, nz), nzc = z1 - z0;
      if (!SYNC_ONLY) body((tile % tiles_x) * TX, (tile / tiles_x) * TY, z0, z1);
      __syncthreads();  // wred is complete; the ring's reads are done
      if (NDOT > 0) {
        if (threadIdx.x < NDOT * nzc) {
          const int d = threadIdx.x / nzc, z = threadIdx.x - d * nzc;
          double t = 0;
          if (!SYNC_ONLY) {
            t = wred[d][0][z];
#pragma unroll
            for (int i = 1; i < TY; ++i) t += wred[d][i][z];
          }
          part[((int64_t)d * tiles + tile) * nz + z0 + z] = t;
        }
        __syncthreads();  // wred is read: the next item may write it
      }
    }
  }

  // The rank's values of NDOT dots from their (tile, plane) partials (dot
  // d's at part + d tiles nz; written by the rank's blocks: read through
  // L2) into own: each plane's tiles added in tile order in double (eight
  // loads in flight) and rounded to S once, a thread per plane and dot; the
  // plane sums added in S in z order, dot d's by thread 32 d. Every thread
  // gets the same bits.
  template <int NDOT>
  __device__ void rank_totals(const double* part) {
    constexpr int BATCH = 8, PER = NT / NDOT;  // planes summed at a time, per dot
    __shared__ S total[2];
    const int d = threadIdx.x / PER, zi = threadIdx.x - d * PER;
    const double* q = part + (int64_t)d * tiles * nz;
    S acc = S(0);
    for (int base = 0; base < nz; base += PER) {
      const int m = min(PER, nz - base);
      if (zi < m) {
        double t = 0;
        for (int i0 = 0; i0 < tiles; i0 += BATCH) {
          double v[BATCH];
#pragma unroll
          for (int j = 0; j < BATCH; ++j) v[j] = i0 + j < tiles ? __ldcg(q + (int64_t)(i0 + j) * nz + base + zi) : 0.0;
#pragma unroll
          for (int j = 0; j < BATCH; ++j) t += v[j];
        }
        sums[threadIdx.x] = S(t);
      }
      __syncthreads();
      if (threadIdx.x < 32 * NDOT && threadIdx.x % 32 == 0) {
        const int dd = threadIdx.x / 32;
        for (int i = 0; i < m; ++i) acc = add_rn(acc, sums[dd * PER + i]);
      }
      __syncthreads();
    }
    if (threadIdx.x < 32 * NDOT && threadIdx.x % 32 == 0) total[threadIdx.x / 32] = acc;
    __syncthreads();
    own[0] = total[0];
    own[1] = NDOT > 1 ? total[1] : S(0);
    __syncthreads();  // total is reused by the next call
  }

  // Thread 0 adds one to a counter, after the fence that publishes what
  // it signals (Comm::publish, or its own): a release.
  __device__ static void signal(unsigned* c) { ScopedAtomic<SCOPE>(*c).fetch_add(1u, cuda::memory_order_relaxed); }

  // The first half of an allreduce of the NDOT dots whose partials this
  // round's items left: Comm::allreduce_start's protocol, but the rank's
  // row is rank_totals of the per-plane partials, formed by block 0 of the
  // rank once every block's partials have arrived, and its stores are
  // published by one fence before the peers' counters are signalled. At
  // one rank a single dot (ONE_RANK: cg's) skips the table round: every
  // block waits for the partials and forms the value itself (a barrier of
  // the rank's blocks, as in Comm::allreduce_start), and no table row is
  // written. Two dots take the table round at one rank too: forming both
  // in every block cost more than the hop it saves (cg1, and pipecg, whose
  // apply hides block 0's sums; PERF.md). With ph >= 0 it is
  // also the exchange of phase ph after the pass that pushed its planes:
  // every block waits for the rank's partials (the barrier of the rank's
  // blocks that Comm::exchange takes), then for bpr arrivals from each
  // neighbour.
  template <int NDOT>
  __device__ bool reduce_start(int slot, int ph = -1) {
    const int rank = this->rank, ndev = this->ndev;
    const double* part = round_parts(this->nred);
    this->publish();
    if (this->tid == 0) {
      signal(this->ctr(rank) + C_RANK);
      if (ph >= 0 && rank > 0) signal(this->ctr(rank - 1) + C_HALO + 2 * ph + 1);  // I am its above
      if (ph >= 0 && rank < ndev - 1) signal(this->ctr(rank + 1) + C_HALO + 2 * ph);
    }
    ++this->nred;
    this->pending = ++this->uses[slot] * ndev;
    const bool alone = ONE_RANK && ndev == 1 && NDOT == 1, forms = this->lb == 0 || alone;
    local = alone;
    if ((forms || ph >= 0) && !this->wait(this->ctr(rank) + C_RANK, this->nred * this->bpr, SITE_RANK)) return false;
    if (forms) {
      rank_totals<NDOT>(part);
      if (!alone && this->tid == 0) {
        for (int peer = 0; peer < ndev; ++peer) {
          S* row = this->template ptr<S>(P_TABLE, peer) + ((int64_t)slot * ndev + rank) * 2;
          row[0] = own[0];
          row[1] = own[1];
        }
        __threadfence();
        for (int peer = 0; peer < ndev; ++peer) signal(this->ctr(peer) + C_TABLE + slot);
      }
    }
    if (ph < 0) return true;
    const unsigned target = ++this->halo_epoch[ph] * this->bpr;
    if (rank > 0 && !this->wait(this->ctr(rank) + C_HALO + 2 * ph, target, SITE_HALO + 2 * ph)) return false;
    return rank == ndev - 1 || this->wait(this->ctr(rank) + C_HALO + 2 * ph + 1, target, SITE_HALO + 2 * ph + 1);
  }

  // The second half: the ndev rows of `slot` added in rank order
  // (Comm::allreduce_finish), or at one rank the value reduce_start formed.
  __device__ bool reduce_finish(int slot, S& a, S& b) {
    if (local) {
      a = own[0];
      b = own[1];
      return true;
    }
    return this->allreduce_finish(slot, a, b);
  }

  template <int NDOT>
  __device__ bool reduce(int slot, S& a, S& b) {
    return reduce_start<NDOT>(slot) && reduce_finish(slot, a, b);
  }

  // The loop test of every driver: the tolerance is not read by the
  // sync-only variant.
  __device__ bool more(int k, S normr) const { return k < this->P.max_iter && (SYNC_ONLY || normr > this->P.tol); }
};

// y = x + a v in S, rounded to T one operation at a time.
template <typename T, typename S>
__device__ __forceinline__ T axpy(S x, S a, T v) {
  return from_s<T>(add_rn(x, mul_rn(a, to_s(v))));
}

// The init of every driver: x = x0 (and pcopy = x0), r = b - A x0 and
// NDOT = 1: r.r, on the march of x0; on_row(z, at, xt, rt) takes each row
// of x0 and r inside the grid (to push them).
template <typename T, typename S, int STENCIL, int NDOT, typename OnRow>
__device__ void init_r(Slab<T, S, STENCIL>& R, T* pcopy, OnRow&& on_row) {
  constexpr int V = Geo<T>::V;
  const T* b = R.input(P_B);
  T *X = R.vec(P_X), *Rv = R.vec(P_R);
  const Planes<T> none{nullptr, nullptr, nullptr};
  R.template for_items<NDOT>([&](int bx0, int by0, int z0, int z1) {
    march<T, S, STENCIL, 1, false, true>(
        R.ring, R.x0_halo(), none, R.ext0, S(0), bx0, by0, z0, z1, [&](int z, const S(&c)[V], const S(&y)[V]) {
          const Row at = R.pts(bx0, by0, z, R.ext.access);
          double part = 0;
          if (at.count > 0) {
            alignas(16) T bt[V];
            load_vec<T>(b, R.pts(bx0, by0, z, R.ext0.access), bt);
            alignas(16) T xt[V];
            alignas(16) T rt[V];
#pragma unroll
            for (int j = 0; j < V; ++j) {
              xt[j] = from_s<T>(c[j]);
              rt[j] = from_s<T>(add_rn(to_s(bt[j]), -y[j]));
              const S rs = to_s(rt[j]);
              if (j < at.count) part += double(mul_rn(rs, rs));
            }
            store_vec<T>(X, at, xt);
            if (pcopy != nullptr) store_vec<T>(pcopy, at, xt);
            store_vec<T>(Rv, at, rt);
            on_row(z, at, xt, rt);
          }
          if (NDOT > 0) R.plane_part(0, z, z0, part);
        });
  });
}

// A v over the rank's slab (v with phase ph's landing planes as its halo):
// emit(z, at, c, y) for each row of the tiles inside the grid, c = v and y
// = (A v) there in S, before the plane's partials.
template <typename T, typename S, int STENCIL, int NDOT, typename Emit>
__device__ void apply(Slab<T, S, STENCIL>& R, const T* v, int ph, Emit&& emit) {
  constexpr int V = Geo<T>::V;
  const Planes<T> none{nullptr, nullptr, nullptr};
  R.template for_items<NDOT>([&](int bx0, int by0, int z0, int z1) {
    march<T, S, STENCIL, 1, false, true>(
        R.ring, R.halo(v, ph), none, R.ext, S(0), bx0, by0, z0, z1, [&](int z, const S(&c)[V], const S(&y)[V]) {
          const Row at = R.pts(bx0, by0, z, R.ext.access);
          double d0 = 0, d1 = 0;
          if (at.count > 0) emit(z, at, c, y, d0, d1);
          if (NDOT > 0) R.plane_part(0, z, z0, d0);
          if (NDOT > 1) R.plane_part(1, z, z0, d1);
        });
  });
}

// An elementwise pass on the rows of the rank's items: row(z, at, d0, d1)
// for each row inside the grid, plane by plane.
template <typename T, typename S, int STENCIL, int NDOT, typename Body>
__device__ void pass(Slab<T, S, STENCIL>& R, Body&& row) {
  R.template for_items<NDOT>([&](int bx0, int by0, int z0, int z1) {
    for (int z = z0; z < z1; ++z) {
      const Row at = R.pts(bx0, by0, z, R.ext.access);
      double d0 = 0, d1 = 0;
      if (at.count > 0) row(z, at, d0, d1);
      if (NDOT > 0) R.plane_part(0, z, z0, d0);
      if (NDOT > 1) R.plane_part(1, z, z0, d1);
    }
  });
}

// K15, cg (_cg_whole_solve): the reference recurrence, K5's exit test (the
// normr of the previous body's top). Vectors: x, r, p, and Ap in P_S; p's
// boundary planes go to landing phase 1.
template <typename T, typename S, int STENCIL>
__device__ void slab_cg(Slab<T, S, STENCIL>& R) {
  constexpr int V = Geo<T>::V;
  T *X = R.vec(P_X), *Rv = R.vec(P_R), *Pv = R.vec(P_P), *AP = R.vec(P_S);
  // init: x = p = x0, r = b - A x0, r.r
  init_r<T, S, STENCIL, 1>(R, Pv, [](int, const Row&, const T(&)[V], const T(&)[V]) {});
  S rtrans, unused;
  HPCCG_TRY(R.template reduce<1>(1, rtrans, unused));
  S normr = sqrt(rtrans);
  if (R.leader) R.P.trace[0] = normr;
  int k = 1;
  bool go = R.more(k, normr);
  if (go && R.leader) R.P.trace[k] = normr;
  S beta = S(0);  // k == 1: p = r
  while (go) {
    // p = r + beta p, pushed; Ap, p.Ap
    pass<T, S, STENCIL, 0>(R, [&](int z, const Row& at, double&, double&) {
      alignas(16) T rt[V];
      alignas(16) T pt[V];
      load_vec<T>(Rv, at, rt);
      load_vec<T>(Pv, at, pt);
#pragma unroll
      for (int j = 0; j < V; ++j) pt[j] = axpy<T, S>(to_s(rt[j]), beta, pt[j]);
      store_vec<T>(Pv, at, pt);
      R.push(1, z, at, pt);
    });
    HPCCG_TRY(R.exchange(1));
    apply<T, S, STENCIL, 1>(R, Pv, 1, [&](int, const Row& at, const S(&c)[V], const S(&y)[V], double& d0, double&) {
      alignas(16) T yt[V];
#pragma unroll
      for (int j = 0; j < V; ++j) {
        yt[j] = from_s<T>(y[j]);
        if (j < at.count) d0 += double(mul_rn(c[j], y[j]));
      }
      store_vec<T>(AP, at, yt);
    });
    S pap;
    HPCCG_TRY(R.template reduce<1>(0, pap, unused));
    const S alpha = rtrans / pap;
    // x += alpha p, r -= alpha Ap (K4's element update), the new r.r
    pass<T, S, STENCIL, 1>(R, [&](int, const Row& at, double& d0, double&) {
      alignas(16) T xt[V];
      alignas(16) T rt[V];
      alignas(16) T pt[V];
      alignas(16) T apt[V];
      load_vec<T>(X, at, xt);
      load_vec<T>(Rv, at, rt);
      load_vec<T>(Pv, at, pt);
      load_vec<T>(AP, at, apt);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        if (j < at.count) update_one<T, S, double>(xt[j], rt[j], pt[j], apt[j], alpha, d0);
      }
      store_vec<T>(X, at, xt);
      store_vec<T>(Rv, at, rt);
    });
    S rr;
    HPCCG_TRY(R.template reduce<1>(1, rr, unused));
    ++k;
    go = R.more(k, normr);
    if (go) {
      beta = rr / rtrans;
      rtrans = rr;
      normr = sqrt(rtrans);
      if (R.leader) R.P.trace[k] = normr;
    }
  }
  R.finish(normr, rtrans, k);
}

// K15, cg1 (_cg1_whole_solve): Chronopoulos-Gear, exchanging r in every
// iteration (phase 1); P_S = A p by recurrence, P_U = A r.
template <typename T, typename S, int STENCIL>
__device__ void slab_cg1(Slab<T, S, STENCIL>& R) {
  constexpr int V = Geo<T>::V;
  T *X = R.vec(P_X), *Rv = R.vec(P_R), *Pv = R.vec(P_P), *Sv = R.vec(P_S), *U = R.vec(P_U);
  init_r<T, S, STENCIL, 0>(R, nullptr,
                           [&](int z, const Row& at, const T(&)[V], const T(&rt)[V]) { R.push(1, z, at, rt); });
  HPCCG_TRY(R.exchange(1));
  // u = A r, r.r, r.u
  auto apply_r = [&]() {
    apply<T, S, STENCIL, 2>(R, Rv, 1, [&](int, const Row& at, const S(&c)[V], const S(&y)[V], double& g,
                                          double& d) {
      alignas(16) T ut[V];
#pragma unroll
      for (int j = 0; j < V; ++j) {
        ut[j] = from_s<T>(y[j]);
        if (j < at.count) {
          g += double(mul_rn(c[j], c[j]));
          d += double(mul_rn(c[j], y[j]));
        }
      }
      store_vec<T>(U, at, ut);
    });
  };
  apply_r();
  S gamma, delta;
  HPCCG_TRY(R.template reduce<2>(0, gamma, delta));
  if (R.leader) R.P.trace[0] = sqrt(gamma);
  S alpha = gamma / delta, gamma_top = gamma, beta = S(0);
  int k = 1;
  while (R.more(k, sqrt(gamma_top))) {
    if (R.leader) R.P.trace[k] = sqrt(gamma);
    const bool first = k == 1;
    // the end of body k-1 (p = r + beta p, s = u + beta s) fused with the
    // start of body k (x += alpha p, r -= alpha s)
    pass<T, S, STENCIL, 0>(R, [&](int z, const Row& at, double&, double&) {
      alignas(16) T rt[V];
      alignas(16) T ut[V];
      alignas(16) T pt[V];
      alignas(16) T st[V];
      alignas(16) T xt[V];
      load_vec<T>(Rv, at, rt);
      load_vec<T>(U, at, ut);
      load_vec<T>(X, at, xt);
      if (!first) {
        load_vec<T>(Pv, at, pt);
        load_vec<T>(Sv, at, st);
      }
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const S rv = to_s(rt[j]), uv = to_s(ut[j]);
        pt[j] = first ? rt[j] : axpy<T, S>(rv, beta, pt[j]);
        st[j] = first ? ut[j] : axpy<T, S>(uv, beta, st[j]);
        xt[j] = axpy<T, S>(to_s(xt[j]), alpha, pt[j]);
        rt[j] = axpy<T, S>(rv, -alpha, st[j]);
      }
      store_vec<T>(Pv, at, pt);
      store_vec<T>(Sv, at, st);
      store_vec<T>(X, at, xt);
      store_vec<T>(Rv, at, rt);
      R.push(1, z, at, rt);
    });
    HPCCG_TRY(R.exchange(1));
    apply_r();
    S g_new, dl;
    HPCCG_TRY(R.template reduce<2>(k & 1, g_new, dl));
    beta = g_new / gamma;
    alpha = g_new / (dl - beta * g_new / alpha);
    gamma_top = gamma;
    gamma = g_new;
    ++k;
  }
  R.finish(sqrt(gamma_top), gamma_top, k);
}

// K16, pipecg (_kernel_pipelined): W = A r, S = A p, Z = A s by recurrence,
// Q = A w the one apply of a body, run while the body's allreduce is in
// flight. w is double-buffered by iteration parity (P_U, P_V): a body's pass
// writes the new w while other blocks may still read the old one in their
// apply, so the pass's exchange is the allreduce's start (reduce_start with
// a phase) and no barrier follows the apply. Landing phases: 1 for r and 2
// for w at the init, 3/4 by iteration parity for w in the loop.
template <typename T, typename S, int STENCIL>
__device__ void slab_pipecg(Slab<T, S, STENCIL>& R) {
  constexpr int V = Geo<T>::V;
  T *X = R.vec(P_X), *Rv = R.vec(P_R), *Pv = R.vec(P_P), *Sv = R.vec(P_S);
  T *Z = R.vec(P_Z), *Q = R.vec(P_Q);
  T* W[2] = {R.vec(P_U), R.vec(P_V)};
  init_r<T, S, STENCIL, 0>(R, nullptr,
                           [&](int z, const Row& at, const T(&)[V], const T(&rt)[V]) { R.push(1, z, at, rt); });
  HPCCG_TRY(R.exchange(1));
  // w = A r, r.r, w.r (the unrounded A r)
  apply<T, S, STENCIL, 2>(R, Rv, 1, [&](int z, const Row& at, const S(&c)[V], const S(&y)[V], double& g,
                                        double& d) {
    alignas(16) T wt[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      wt[j] = from_s<T>(y[j]);
      if (j < at.count) {
        g += double(mul_rn(c[j], c[j]));
        d += double(mul_rn(y[j], c[j]));
      }
    }
    store_vec<T>(W[0], at, wt);
    R.push(2, z, at, wt);
  });
  // q = A w, hiding the allreduce
  auto apply_w = [&](const T* w, int ph) {
    apply<T, S, STENCIL, 0>(R, w, ph, [&](int, const Row& at, const S(&)[V], const S(&y)[V], double&, double&) {
      alignas(16) T qt[V];
#pragma unroll
      for (int j = 0; j < V; ++j) qt[j] = from_s<T>(y[j]);
      store_vec<T>(Q, at, qt);
    });
  };
  HPCCG_TRY(R.template reduce_start<2>(0, 2));
  apply_w(W[0], 2);
  S gamma, delta;
  HPCCG_TRY(R.reduce_finish(0, gamma, delta));
  if (R.leader) R.P.trace[0] = sqrt(gamma);
  S alpha = gamma / delta, gamma_top = gamma, beta = S(0);
  int k = 1;
  while (R.more(k, sqrt(gamma_top))) {
    if (R.leader) R.P.trace[k] = sqrt(gamma);
    const bool first = k == 1;
    const int ph = 3 + (k & 1), slot = k & 1;
    const T* w_old = W[(k + 1) & 1];
    T* w_new = W[k & 1];
    pass<T, S, STENCIL, 2>(R, [&](int z, const Row& at, double& g, double& d) {
      alignas(16) T rt[V];
      alignas(16) T wt[V];
      alignas(16) T qt[V];
      alignas(16) T pt[V];
      alignas(16) T st[V];
      alignas(16) T zt[V];
      alignas(16) T xt[V];
      load_vec<T>(Rv, at, rt);
      load_vec<T>(w_old, at, wt);
      load_vec<T>(Q, at, qt);
      load_vec<T>(X, at, xt);
      if (!first) {
        load_vec<T>(Pv, at, pt);
        load_vec<T>(Sv, at, st);
        load_vec<T>(Z, at, zt);
      }
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const S rv = to_s(rt[j]), wv = to_s(wt[j]), qv = to_s(qt[j]);
        pt[j] = first ? rt[j] : axpy<T, S>(rv, beta, pt[j]);
        st[j] = first ? wt[j] : axpy<T, S>(wv, beta, st[j]);
        zt[j] = first ? qt[j] : axpy<T, S>(qv, beta, zt[j]);
        xt[j] = axpy<T, S>(to_s(xt[j]), alpha, pt[j]);
        rt[j] = axpy<T, S>(rv, -alpha, st[j]);
        wt[j] = axpy<T, S>(wv, -alpha, zt[j]);
        if (j < at.count) {
          const S rs = to_s(rt[j]), ws = to_s(wt[j]);
          g += double(mul_rn(rs, rs));
          d += double(mul_rn(ws, rs));
        }
      }
      store_vec<T>(Pv, at, pt);
      store_vec<T>(Sv, at, st);
      store_vec<T>(Z, at, zt);
      store_vec<T>(X, at, xt);
      store_vec<T>(Rv, at, rt);
      store_vec<T>(w_new, at, wt);
      R.push(ph, z, at, wt);
    });
    HPCCG_TRY(R.template reduce_start<2>(slot, ph));
    apply_w(w_new, ph);
    S g_new, dl;
    HPCCG_TRY(R.reduce_finish(slot, g_new, dl));
    beta = g_new / gamma;
    alpha = g_new / (dl - beta * g_new / alpha);
    gamma_top = gamma;
    gamma = g_new;
    ++k;
  }
  R.finish(sqrt(gamma_top), gamma_top, k);
}

template <typename T, typename S, int STENCIL, int METHOD>
__global__ void __launch_bounds__(NT, coll_blocks<METHOD>()) collective_kernel(const __grid_constant__ Params<S> P) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ double wred[2][TY][COLL_ZC];
  __shared__ S sums[NT];
  Slab<T, S, STENCIL> R(P, reinterpret_cast<T*>(smem_raw), wred, sums);
  if (METHOD == CG) {
    slab_cg(R);
  } else if (METHOD == CG1) {
    slab_cg1(R);
  } else {
    slab_pipecg(R);
  }
}

template <typename T, typename S, int STENCIL>
const void* kernel_for_stencil(int method) {
  if (method == CG) return (const void*)collective_kernel<T, S, STENCIL, CG>;
  if (method == CG1) return (const void*)collective_kernel<T, S, STENCIL, CG1>;
  return (const void*)collective_kernel<T, S, STENCIL, PIPECG>;
}

template <typename T, typename S>
const void* kernel_for(int stencil, int method) {
  return stencil == 27 ? kernel_for_stencil<T, S, 27>(method) : kernel_for_stencil<T, S, 7>(method);
}

// The cooperative grid of a launch: the z chunk, each rank's work items and
// blocks.
struct Geometry {
  int zc;
  int items;
  int bpr;
};

// The geometry of ndev ranks of nx*ny*nz on the current device: every
// block resident at once (min(occupancy, coll_blocks()) on each SM,
// shared by the ranks), a rank's blocks capped by its work items; of the z
// chunks COLL_ZC, COLL_ZC/2, ..., 1 the one whose busiest block stages the
// fewest planes (ceil(items / bpr) items of zc + 2 planes), the larger on a
// tie (K5's rule). Returns a CUDA error code.
template <typename T, typename S>
int geometry(int nx, int ny, int nz, int stencil, int method, int ndev, Geometry* g) {
  if ((stencil != 27 && stencil != 7) || method < CG || method > PIPECG || nx < 1 || ny < 1 || nz < 1 ||
      ndev < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const void* kern = kernel_for<T, S>(stencil, method);
  int dev = 0, sms = 0, coop_ok = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop_ok, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, NT, COLL_SMEM);
  if (err != cudaSuccess) return (int)err;
  if (!coop_ok || per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  const int bound = method == PIPECG ? coll_blocks<PIPECG>() : coll_blocks<CG>();
  const long long per_rank = (long long)(per_sm < bound ? per_sm : bound) * sms / ndev;
  if (per_rank < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  const long long tiles = (long long)ceil_div(nx, Geo<T>::TX) * ceil_div(ny, TY);
  long long best = LLONG_MAX, items = 0, bpr = 0;
  for (int zc = COLL_ZC; zc >= 1; zc /= 2) {
    const long long it = tiles * ceil_div(nz, zc);
    const long long bl = it < per_rank ? it : per_rank;
    const long long cost = (it + bl - 1) / bl * (zc + 2);
    if (cost < best) {
      best = cost;
      g->zc = zc;
      items = it;
      bpr = bl;
    }
  }
  if (items > INT_MAX) return (int)cudaErrorInvalidValue;
  g->items = (int)items;
  g->bpr = (int)bpr;
  return (int)cudaSuccess;
}

bool valid_access(int a, int esize) { return (a == 2 || a == 4 || a == 8 || a == 16) && a >= esize; }

template <typename T, typename S>
int launch(const long long* ptrs, S* trace, S* stats, int* err, int ndev, int nx, int ny, int nz, long long pitch,
           int access, int init_access, long long nparts, int stencil, int method, int max_iter, double tol,
           long long wait_ns, void* stream) {
  Geometry g;
  const int e = geometry<T, S>(nx, ny, nz, stencil, method, ndev, &g);
  if (e != (int)cudaSuccess) return e;
  const int esize = (int)sizeof(T);
  const long long tiles = (long long)ceil_div(nx, Geo<T>::TX) * ceil_div(ny, TY);
  if (wait_ns < 0 || pitch < (long long)nx * ny || pitch * esize % 16 != 0 || nparts < 4 * tiles * nz) {
    return (int)cudaErrorInvalidValue;
  }
  if (!valid_access(access, esize) || !valid_access(init_access, esize)) return (int)cudaErrorMisalignedAddress;
  Params<S> params{{ptrs, trace, stats, err, ndev, g.bpr, max_iter, S(tol), (unsigned long long)wait_ns},
                   nx,
                   ny,
                   nz,
                   g.zc,
                   access,
                   init_access,
                   pitch};
  void* args[] = {&params};
  return (int)cudaLaunchCooperativeKernel(kernel_for<T, S>(stencil, method), dim3(ndev * g.bpr), dim3(NT), args,
                                          COLL_SMEM, (cudaStream_t)stream);
}

template <typename T, typename S>
int geometry_out(int nx, int ny, int nz, int stencil, int method, int ndev, int* out) {
  Geometry g;
  const int err = geometry<T, S>(nx, ny, nz, stencil, method, ndev, &g);
  if (err != (int)cudaSuccess) return err;
  out[0] = Geo<T>::TX;
  out[1] = TY;
  out[2] = g.zc;
  out[3] = g.items;
  out[4] = g.bpr;
  return 0;
}

}  // namespace

extern "C" {

// The cooperative grid of a launch of ndev ranks of nx*ny*nz on the current
// device: out = {tile width, tile height, z-planes per work item, work
// items of a rank, blocks of a rank}. dtype: 0 float32, 1 float64, 2
// bfloat16; method: 0 cg, 1 cg1, 2 pipecg. Returns a CUDA error code.
int hpccg_collective_geometry(int nx, int ny, int nz, int dtype, int stencil, int method, int ndev, int* out) {
  if (dtype == 0) return geometry_out<float, float>(nx, ny, nz, stencil, method, ndev, out);
  if (dtype == 1) return geometry_out<double, double>(nx, ny, nz, stencil, method, ndev, out);
  if (dtype == 2) return geometry_out<__nv_bfloat16, float>(nx, ny, nz, stencil, method, ndev, out);
  return (int)cudaErrorInvalidValue;
}

// The number of counter words per rank and of pointer-table rows.
int hpccg_collective_layout(int which) { return which == 0 ? NCTR : NKIND; }

// ptrs: the NKIND x ndev pointer table (collective.cuh); P_PARTS rows point
// at nparts doubles per rank (4 tiles nz: two rounds of two dots), P_H rows
// at (5 phases, 2 sides) landing planes `pitch` elements apart (a multiple
// of 16 bytes). access / init_access: the widest of 16, 8, 4, 2 bytes that
// divides nx * sizeof(T), the state vectors' and landing planes' pointers
// (and b's and x0's).
int hpccg_collective_f32(const long long* ptrs, float* trace, float* stats, int* err, int ndev, int nx, int ny,
                         int nz, long long pitch, int access, int init_access, long long nparts, int stencil,
                         int method, int max_iter, double tol, long long wait_ns, void* stream) {
  return launch<float, float>(ptrs, trace, stats, err, ndev, nx, ny, nz, pitch, access, init_access, nparts,
                              stencil, method, max_iter, tol, wait_ns, stream);
}

int hpccg_collective_f64(const long long* ptrs, double* trace, double* stats, int* err, int ndev, int nx, int ny,
                         int nz, long long pitch, int access, int init_access, long long nparts, int stencil,
                         int method, int max_iter, double tol, long long wait_ns, void* stream) {
  return launch<double, double>(ptrs, trace, stats, err, ndev, nx, ny, nz, pitch, access, init_access, nparts,
                                stencil, method, max_iter, tol, wait_ns, stream);
}

// bfloat16 vectors (the b, x0 and state rows of ptrs, the landing planes);
// the allreduce table, the trace and the stats are float32.
int hpccg_collective_bf16(const long long* ptrs, float* trace, float* stats, int* err, int ndev, int nx, int ny,
                          int nz, long long pitch, int access, int init_access, long long nparts, int stencil,
                          int method, int max_iter, double tol, long long wait_ns, void* stream) {
  return launch<__nv_bfloat16, float>(ptrs, trace, stats, err, ndev, nx, ny, nz, pitch, access, init_access,
                                      nparts, stencil, method, max_iter, tol, wait_ns, stream);
}

}  // extern "C"
