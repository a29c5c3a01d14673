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
// the result back once.
//
// Ranks. The mesh is single-controller (parallel/mesh.py): every rank of
// the launch lives on this device, and rank r's z-block is global planes
// [r*nz, (r+1)*nz). The grid is ndev x bpr blocks, every block resident at
// once (cooperative launch: occupancy x SMs, else the launch is refused);
// block b serves rank b / bpr. Ranks meet only through memory that a peer
// GPU could also write, through per-rank pointer tables: no grid-wide sync,
// so the ranks are not in lockstep and the exchange protocol below is what
// orders them. A multi-card launch would only fill the pointer tables with
// peer (P2P) addresses; it is not built yet (ROADMAP).
//
// Protocol (JAX's phase and parity discipline, collective_kernel.py:22-32):
//   - rank barrier: a rank's blocks sync through an epoch counter in global
//     memory (release increments, acquire waits);
//   - halo: the pass that produces a vector also writes its first real
//     plane into the below-neighbour's landing plane and its last into the
//     above-neighbour's, then release-increments the neighbours' arrival
//     counter of that phase; a reader acquire-waits for bpr arrivals per
//     exchange from each neighbour. Each rank has (5, 2, ny, nx) landing
//     planes, one pair per phase: K15 uses phase 0 for the init exchange
//     and 1 for the loop; K16 phases 0-2 for its three init exchanges and
//     3/4 by iteration parity in the loop;
//   - allreduce: each block writes its partials, release-increments its
//     rank's counter; block 0 of the rank waits for all, sums them in a
//     fixed tree, writes the rank's row into the slot's table of every
//     peer and release-increments each peer's slot counter; every block
//     waits for ndev rows and sums them in rank order. Slots alternate by
//     parity, so a fast rank's next row never lands in a round a slow rank
//     is still summing. K15's single-buffered phase 1 is safe because a
//     rank pushes into it again only after an allreduce that needs the
//     reader's row, which the reader writes after it read the planes.
// Uniform scalars: every block of every rank sums the same rows in the same
// order, so all hold bit-identical alpha, beta and gamma and take the same
// exit decision; two solves are bit-identical (no float atomics).
//
// Bounded waits: every spin-wait gives up after wait_ns of %globaltimer,
// writes an error word (site, rank, expected count), and the block leaves;
// the other blocks see the word and leave too. The wrapper
// (ops/cuda/collective.py) raises RuntimeError with it.
//
// What bounds it on this card. cg1 moves about 14 vector passes per
// iteration (x, r, p, s updates: 12; A r with its dots: the apply reads r
// and writes u): 4 x 100^3 f32 is ~224 MB, ~67 us at 3.35 TB/s; at
// 1 x 100^3 the state (20 MB) sits in the 50 MB L2 and the waits, several
// per iteration, are the likely bound, as the grid syncs bound K5. The
// apply is hpccg::march_tile (stencil_tile.cuh) over the rank's slab with
// landing planes as its z-halo; the dots are fused into the apply or
// the update pass. Offsets are 64-bit. Simple first: no TMA, no clusters;
// vector loads go through L2 (__ldcg) since other blocks write them
// during the launch.

#include <cuda/atomic>
#include <cuda_runtime.h>
#include <stdint.h>

#include "reduce.cuh"
#include "stencil_tile.cuh"

namespace {

using hpccg::TILE_NT;
using hpccg::TILE_X;
using hpccg::TILE_Y;
constexpr int CZ = 8;  // z-planes per work item

enum Method { CG = 0, CG1 = 1, PIPECG = 2 };
// rows of the pointer table (NKIND x ndev addresses); the same numbers as
// ops/cuda/collective.py
enum { P_B, P_X0, P_X, P_R, P_P, P_S, P_U, P_Z, P_Q, P_H, P_PARTS, P_TABLE, P_CTR, NKIND };
// a rank's counters: halo arrivals [phase][from below, from above], the
// rank barrier, the partials' arrivals, the two allreduce slots
enum { C_HALO = 0, C_BAR = 10, C_RANK = 11, C_TABLE = 12, NCTR = 16 };
// error word: [set, site, rank, expected count]; the site of a halo wait is
// SITE_HALO + 2 * phase + direction
enum { SITE_BAR = 1, SITE_RANK = 2, SITE_TABLE = 3, SITE_HALO = 16 };

template <typename T>
struct Params {
  const long long* ptrs;
  T* trace;
  T* stats;
  int* err;
  int ndev, bpr, nx, ny, nz, max_iter;
  T tol;
  unsigned long long wait_ns;
};

__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

using SysAtomic = cuda::atomic_ref<unsigned, cuda::thread_scope_system>;

__device__ __forceinline__ void release_add(unsigned* c) {
  SysAtomic(*c).fetch_add(1u, cuda::memory_order_release);
}

__host__ __device__ __forceinline__ int ceil_div(int a, int b) { return (a + b - 1) / b; }

long long work_items(int nx, int ny, int nz) {
  return (long long)ceil_div(nx, TILE_X) * ceil_div(ny, TILE_Y) * ceil_div(nz, CZ);
}

// One block's view of its rank and the protocol.
template <typename T, int STENCIL>
struct Rank {
  const Params<T> P;
  T (*tile)[TILE_X + 2];
  T* red;
  int rank, lb, tid, ndev, bpr, nx, ny, nz;
  int64_t plane, n;
  int tiles_x, tiles_y, items;
  unsigned bar_epoch = 0, nred = 0, halo_epoch[5] = {0, 0, 0, 0, 0}, uses[2] = {0, 0};
  unsigned pending = 0;  // the slot count an allreduce_finish waits for
  bool leader;

  __device__ Rank(const Params<T>& p, T (*t)[TILE_X + 2], T* r) : P(p), tile(t), red(r) {
    ndev = P.ndev;
    bpr = P.bpr;
    rank = blockIdx.x / bpr;
    lb = blockIdx.x % bpr;
    tid = threadIdx.y * TILE_X + threadIdx.x;
    nx = P.nx;
    ny = P.ny;
    nz = P.nz;
    plane = (int64_t)nx * ny;
    n = plane * nz;
    tiles_x = ceil_div(nx, TILE_X);
    tiles_y = ceil_div(ny, TILE_Y);
    items = tiles_x * tiles_y * ceil_div(nz, CZ);
    leader = rank == 0 && lb == 0 && tid == 0;
  }

  template <typename V>
  __device__ V* ptr(int kind, int r) const {
    return reinterpret_cast<V*>(P.ptrs[kind * ndev + r]);
  }
  __device__ unsigned* ctr(int r) const { return ptr<unsigned>(P_CTR, r); }
  // rank's vector of `kind`
  __device__ T* vec(int kind) const { return ptr<T>(kind, rank); }

  __device__ T bsum(T v) {
    const T t = hpccg::block_sum<T, TILE_NT>(v, red, tid);
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
      while (SysAtomic(*c).load(cuda::memory_order_acquire) < target) {
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
    if (tid == 0) __threadfence_system();
  }

  // Barrier of the rank's blocks (what one block wrote, the others read).
  __device__ bool rank_barrier() {
    publish();
    if (tid == 0) release_add(ctr(rank) + C_BAR);
    return wait(ctr(rank) + C_BAR, ++bar_epoch * bpr, SITE_BAR);
  }

  // Halo exchange of phase ph after the pass that pushed its planes: the
  // rank barrier, then bpr arrivals from each neighbour.
  __device__ bool exchange(int ph) {
    publish();
    if (tid == 0) {
      release_add(ctr(rank) + C_BAR);
      if (rank > 0) release_add(ctr(rank - 1) + C_HALO + 2 * ph + 1);  // I am its above
      if (rank < ndev - 1) release_add(ctr(rank + 1) + C_HALO + 2 * ph);
    }
    if (!wait(ctr(rank) + C_BAR, ++bar_epoch * bpr, SITE_BAR)) return false;
    const unsigned target = ++halo_epoch[ph] * bpr;
    if (rank > 0 && !wait(ctr(rank) + C_HALO + 2 * ph, target, SITE_HALO + 2 * ph)) return false;
    if (rank < ndev - 1 && !wait(ctr(rank) + C_HALO + 2 * ph + 1, target, SITE_HALO + 2 * ph + 1)) {
      return false;
    }
    return true;
  }

  // Real element i of a vector goes to the neighbours' landing planes of
  // phase ph.
  __device__ void push(int ph, int64_t i, T v) {
    if (i < plane && rank > 0) ptr<T>(P_H, rank - 1)[(2 * ph + 1) * plane + i] = v;
    if (i >= n - plane && rank < ndev - 1) ptr<T>(P_H, rank + 1)[2 * ph * plane + i - (n - plane)] = v;
  }

  // f(i) for each real element i of the rank this block takes.
  template <typename F>
  __device__ void each(F&& f) {
    const int64_t stride = (int64_t)bpr * TILE_NT;
    for (int64_t i = (int64_t)lb * TILE_NT + tid; i < n; i += stride) f(i);
  }

  // A v over the rank's slab, with phase ph's landing planes as the planes
  // at z = -1 and z = nz: emit(i, c, y) with c = v[i], y = (A v)[i].
  template <typename Emit>
  __device__ void apply(int kind, int ph, Emit&& emit) {
    const T* v = vec(kind);
    const T* lo = ptr<T>(P_H, rank) + 2 * ph * plane;
    const T* hi = lo + plane;
    for (int it = lb; it < items; it += bpr) {
      const int cz = it / (tiles_x * tiles_y), rem = it % (tiles_x * tiles_y);
      const int bx0 = (rem % tiles_x) * TILE_X, by0 = (rem / tiles_x) * TILE_Y;
      const int ix = bx0 + threadIdx.x, iy = by0 + threadIdx.y;
      const bool inside = ix < nx && iy < ny;
      const int64_t inplane = (int64_t)iy * nx + ix;
      const int z0 = cz * CZ;
      hpccg::march_tile<T, STENCIL>(
          tile, bx0, by0, z0, min(z0 + CZ, nz),
          [&](int zz, int gy, int gx) -> T {
            if (gx < 0 || gx >= nx || gy < 0 || gy >= ny) return T(0);
            const T* src = zz < 0 ? lo : (zz >= nz ? hi : v + (int64_t)zz * plane);
            return __ldcg(src + (int64_t)gy * nx + gx);
          },
          [&](int z, T c, T y) {
            if (inside) emit((int64_t)z * plane + inplane, c, y);
          });
    }
  }

  // The first half of an allreduce of (a, b) over the ranks in `slot`:
  // this block's partials, and (block 0 of the rank) the rank's row in
  // every peer's table.
  __device__ bool allreduce_start(T a, T b, int slot) {
    const T sa = bsum(a), sb = bsum(b);
    T* parts = ptr<T>(P_PARTS, rank);
    if (tid == 0) {
      parts[2 * lb] = sa;
      parts[2 * lb + 1] = sb;
    }
    publish();
    if (tid == 0) release_add(ctr(rank) + C_RANK);
    ++nred;
    pending = ++uses[slot] * ndev;
    if (lb != 0) return true;
    if (!wait(ctr(rank) + C_RANK, nred * bpr, SITE_RANK)) return false;
    T pa = T(0), pb = T(0);
    for (int j = tid; j < bpr; j += TILE_NT) {
      pa += __ldcg(parts + 2 * j);
      pb += __ldcg(parts + 2 * j + 1);
    }
    pa = bsum(pa);
    pb = bsum(pb);
    if (tid == 0) {
      for (int peer = 0; peer < ndev; ++peer) {
        T* row = ptr<T>(P_TABLE, peer) + ((int64_t)slot * ndev + rank) * 2;
        row[0] = pa;
        row[1] = pb;
      }
      __threadfence_system();
      for (int peer = 0; peer < ndev; ++peer) release_add(ctr(peer) + C_TABLE + slot);
    }
    return true;
  }

  // The second half: wait for the ndev rows of `slot` and sum them in rank
  // order (the same bits in every block).
  __device__ bool allreduce_finish(int slot, T& a, T& b) {
    if (!wait(ctr(rank) + C_TABLE + slot, pending, SITE_TABLE)) return false;
    __shared__ T tot[2];
    if (tid == 0) {
      const T* tab = ptr<T>(P_TABLE, rank) + (int64_t)slot * ndev * 2;
      T sa = __ldcg(tab), sb = __ldcg(tab + 1);
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

  __device__ bool allreduce(T a, T b, int slot, T& ga, T& gb) {
    return allreduce_start(a, b, slot) && allreduce_finish(slot, ga, gb);
  }

  __device__ void finish(T normr, T rtrans, int k) {
    if (leader) {
      P.stats[0] = normr;
      P.stats[1] = rtrans;
      P.stats[2] = T(k - 1);
      P.stats[3] = T(0);
    }
  }
};

#define TRY(cond) \
  if (!(cond)) return

// K15, method cg: the reference recurrence (_cg_whole_solve), exchanging p
// (phase 0 at the init, 1 in the loop); S holds A p.
template <typename T, int STENCIL>
__device__ void solve_cg(Rank<T, STENCIL>& R) {
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
  TRY(R.exchange(0));
  T rr = T(0);
  R.apply(P_P, 0, [&](int64_t i, T, T y) {
    const T r = b[i] - y;
    Rv[i] = r;
    rr += r * r;
  });
  T rtrans, unused;
  TRY(R.allreduce(rr, T(0), 0, rtrans, unused));
  T normr = sqrt(rtrans), rtrans_old = rtrans;
  if (R.leader) R.P.trace[0] = normr;
  int k = 1;
  while (k < R.P.max_iter && normr > R.P.tol) {
    // allreduce 1: r.r (at k == 1 the init partials again: the same bits)
    TRY(R.allreduce(rr, T(0), 1, rtrans, unused));
    const T beta = k == 1 ? T(0) : rtrans / rtrans_old;
    normr = sqrt(rtrans);
    if (R.leader) R.P.trace[k] = normr;
    R.each([&](int64_t i) {
      const T p = __ldcg(Rv + i) + beta * __ldcg(Pv + i);
      Pv[i] = p;
      R.push(1, i, p);
    });
    TRY(R.exchange(1));
    T pap_blk = T(0), pap;
    R.apply(P_P, 1, [&](int64_t i, T c, T y) {
      AP[i] = y;
      pap_blk += c * y;
    });
    // allreduce 2: p.Ap
    TRY(R.allreduce(pap_blk, T(0), 0, pap, unused));
    const T alpha = rtrans / pap;
    rr = T(0);
    R.each([&](int64_t i) {
      X[i] = __ldcg(X + i) + alpha * __ldcg(Pv + i);
      const T r = __ldcg(Rv + i) - alpha * __ldcg(AP + i);
      Rv[i] = r;
      rr += r * r;
    });
    rtrans_old = rtrans;
    ++k;
  }
  R.finish(normr, rtrans, k);
}

// K15, method cg1: Chronopoulos-Gear (_cg1_whole_solve), exchanging x at
// the init (phase 0) and r in every iteration (phase 1); S = A p by
// recurrence, U = A r.
template <typename T, int STENCIL>
__device__ void solve_cg1(Rank<T, STENCIL>& R) {
  const T* b = R.template ptr<T>(P_B, R.rank);
  const T* x0 = R.template ptr<T>(P_X0, R.rank);
  T *X = R.vec(P_X), *Rv = R.vec(P_R), *Pv = R.vec(P_P), *S = R.vec(P_S), *U = R.vec(P_U);
  R.each([&](int64_t i) {
    const T v = x0[i];
    X[i] = v;
    R.push(0, i, v);
  });
  TRY(R.exchange(0));
  R.apply(P_X, 0, [&](int64_t i, T, T y) {
    const T r = b[i] - y;
    Rv[i] = r;
    R.push(1, i, r);
  });
  TRY(R.exchange(1));
  T g = T(0), d = T(0);
  R.apply(P_R, 1, [&](int64_t i, T c, T y) {
    U[i] = y;
    g += c * c;
    d += c * y;
  });
  T gamma, delta;
  TRY(R.allreduce(g, d, 0, gamma, delta));
  if (R.leader) R.P.trace[0] = sqrt(gamma);
  T alpha = gamma / delta, gamma_top = gamma, beta = T(0);
  int k = 1;
  while (k < R.P.max_iter && sqrt(gamma_top) > R.P.tol) {
    if (R.leader) R.P.trace[k] = sqrt(gamma);
    const bool first = k == 1;
    // the end of body k-1 (p = r + beta p, s = u + beta s) fused with the
    // start of body k (x += alpha p, r -= alpha s)
    R.each([&](int64_t i) {
      const T rv = __ldcg(Rv + i), uv = __ldcg(U + i);
      const T p = first ? rv : rv + beta * __ldcg(Pv + i);
      const T s = first ? uv : uv + beta * __ldcg(S + i);
      Pv[i] = p;
      S[i] = s;
      X[i] = __ldcg(X + i) + alpha * p;
      const T r = rv - alpha * s;
      Rv[i] = r;
      R.push(1, i, r);
    });
    TRY(R.exchange(1));
    g = T(0);
    d = T(0);
    R.apply(P_R, 1, [&](int64_t i, T c, T y) {
      U[i] = y;
      g += c * c;
      d += c * y;
    });
    T g_new, dl;
    TRY(R.allreduce(g, d, k & 1, g_new, dl));
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
// flight.
template <typename T, int STENCIL>
__device__ void solve_pipecg(Rank<T, STENCIL>& R) {
  const T* b = R.template ptr<T>(P_B, R.rank);
  const T* x0 = R.template ptr<T>(P_X0, R.rank);
  T *X = R.vec(P_X), *Rv = R.vec(P_R), *W = R.vec(P_U), *Pv = R.vec(P_P), *S = R.vec(P_S);
  T *Z = R.vec(P_Z), *Q = R.vec(P_Q);
  R.each([&](int64_t i) {
    const T v = x0[i];
    X[i] = v;
    R.push(0, i, v);
  });
  TRY(R.exchange(0));
  R.apply(P_X, 0, [&](int64_t i, T, T y) {
    const T r = b[i] - y;
    Rv[i] = r;
    R.push(1, i, r);
  });
  TRY(R.exchange(1));
  T g = T(0), d = T(0);
  R.apply(P_R, 1, [&](int64_t i, T c, T y) {
    W[i] = y;
    g += c * c;
    d += y * c;
    R.push(2, i, y);
  });
  TRY(R.exchange(2));
  TRY(R.allreduce_start(g, d, 0));
  R.apply(P_U, 2, [&](int64_t i, T, T y) { Q[i] = y; });
  TRY(R.rank_barrier());  // Q complete before the first pass reads it
  T gamma, delta;
  TRY(R.allreduce_finish(0, gamma, delta));
  if (R.leader) R.P.trace[0] = sqrt(gamma);
  T alpha = gamma / delta, gamma_top = gamma, beta = T(0);
  int k = 1;
  while (k < R.P.max_iter && sqrt(gamma_top) > R.P.tol) {
    if (R.leader) R.P.trace[k] = sqrt(gamma);
    const bool first = k == 1;
    const int ph = 3 + (k & 1), slot = k & 1;
    g = T(0);
    d = T(0);
    R.each([&](int64_t i) {
      const T rv = __ldcg(Rv + i), wv = __ldcg(W + i), qv = __ldcg(Q + i);
      const T p = first ? rv : rv + beta * __ldcg(Pv + i);
      const T s = first ? wv : wv + beta * __ldcg(S + i);
      const T z = first ? qv : qv + beta * __ldcg(Z + i);
      Pv[i] = p;
      S[i] = s;
      Z[i] = z;
      X[i] = __ldcg(X + i) + alpha * p;
      const T r = rv - alpha * s;
      const T w = wv - alpha * z;
      Rv[i] = r;
      W[i] = w;
      g += r * r;
      d += w * r;
      R.push(ph, i, w);
    });
    TRY(R.exchange(ph));
    TRY(R.allreduce_start(g, d, slot));
    R.apply(P_U, ph, [&](int64_t i, T, T y) { Q[i] = y; });  // hides the allreduce
    TRY(R.rank_barrier());  // W read and Q written before the next pass
    T g_new, dl;
    TRY(R.allreduce_finish(slot, g_new, dl));
    beta = g_new / gamma;
    alpha = g_new / (dl - beta * g_new / alpha);
    gamma_top = gamma;
    gamma = g_new;
    ++k;
  }
  R.finish(sqrt(gamma_top), gamma_top, k);
}

// float32 cg fits in 80 registers, 3 blocks per SM; the other instances
// are held to 128 registers, 2 blocks per SM
template <typename T, int STENCIL, int METHOD>
__global__ void __launch_bounds__(TILE_NT, METHOD == CG && sizeof(T) == 4 ? 3 : 2)
    collective_kernel(const Params<T> P) {
  __shared__ T tile[TILE_Y + 2][TILE_X + 2];
  __shared__ T red[TILE_NT];
  Rank<T, STENCIL> R(P, tile, red);
  if (METHOD == CG) {
    solve_cg(R);
  } else if (METHOD == CG1) {
    solve_cg1(R);
  } else {
    solve_pipecg(R);
  }
}

template <typename T, int STENCIL>
const void* kernel_for_stencil(int method) {
  if (method == CG) return (const void*)collective_kernel<T, STENCIL, CG>;
  if (method == CG1) return (const void*)collective_kernel<T, STENCIL, CG1>;
  return (const void*)collective_kernel<T, STENCIL, PIPECG>;
}

template <typename T>
const void* kernel_for(int stencil, int method) {
  return stencil == 27 ? kernel_for_stencil<T, 27>(method) : kernel_for_stencil<T, 7>(method);
}

// Blocks of kernel<T>(stencil, method) resident at once on the current
// device (occupancy x SMs). Returns a CUDA error code.
template <typename T>
int resident_blocks(int stencil, int method, int* blocks) {
  if ((stencil != 27 && stencil != 7) || method < CG || method > PIPECG) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0, coop_ok = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop_ok, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel_for<T>(stencil, method), TILE_NT, 0);
  }
  if (err != cudaSuccess) return (int)err;
  if (!coop_ok || per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  *blocks = per_sm * sms;
  return (int)cudaSuccess;
}

template <typename T>
int launch(const long long* ptrs, T* trace, T* stats, int* err, int ndev, int bpr, int nx, int ny, int nz,
           int stencil, int method, int max_iter, double tol, long long wait_ns, void* stream) {
  int resident = 0;
  const int e = resident_blocks<T>(stencil, method, &resident);
  if (e != (int)cudaSuccess) return e;
  if (ndev < 1 || bpr < 1 || nx < 1 || ny < 1 || nz < 1 || wait_ns < 0) return (int)cudaErrorInvalidValue;
  if ((long long)ndev * bpr > resident) return (int)cudaErrorCooperativeLaunchTooLarge;
  Params<T> params{ptrs, trace, stats, err, ndev, bpr, nx, ny, nz, max_iter, T(tol),
                   (unsigned long long)wait_ns};
  void* args[] = {&params};
  return (int)cudaLaunchCooperativeKernel(kernel_for<T>(stencil, method), dim3(ndev * bpr),
                                          dim3(TILE_X, TILE_Y), args, 0, (cudaStream_t)stream);
}

}  // namespace

extern "C" {

// Blocks resident at once for the kernel (dtype 0 float32, 1 float64;
// method 0 cg, 1 cg1, 2 pipecg), or minus a CUDA error code: the grid of a
// launch is ndev x bpr blocks and must not exceed it.
int hpccg_collective_resident_blocks(int dtype, int stencil, int method) {
  int blocks = 0;
  int err = (int)cudaErrorInvalidValue;
  if (dtype == 0) err = resident_blocks<float>(stencil, method, &blocks);
  if (dtype == 1) err = resident_blocks<double>(stencil, method, &blocks);
  return err == (int)cudaSuccess ? blocks : -err;
}

// Work items of one rank's nx*ny*nz block: (x-tile, y-tile, z-chunk)
// triples, which the rank's blocks take in turns.
int hpccg_collective_work_items(int nx, int ny, int nz) { return (int)work_items(nx, ny, nz); }

// The number of counter words per rank and of pointer-table rows.
int hpccg_collective_layout(int which) { return which == 0 ? NCTR : NKIND; }

int hpccg_collective_f32(const long long* ptrs, float* trace, float* stats, int* err, int ndev, int bpr, int nx,
                         int ny, int nz, int stencil, int method, int max_iter, double tol, long long wait_ns,
                         void* stream) {
  return launch<float>(ptrs, trace, stats, err, ndev, bpr, nx, ny, nz, stencil, method, max_iter, tol, wait_ns,
                       stream);
}

int hpccg_collective_f64(const long long* ptrs, double* trace, double* stats, int* err, int ndev, int bpr, int nx,
                         int ny, int nz, int stencil, int method, int max_iter, double tol, long long wait_ns,
                         void* stream) {
  return launch<double>(ptrs, trace, stats, err, ndev, bpr, nx, ny, nz, stencil, method, max_iter, tol, wait_ns,
                        stream);
}

}  // extern "C"
