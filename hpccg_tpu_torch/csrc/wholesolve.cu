// Whole-solve CG kernel for Hopper (sm_90a): K5 and K6 of the port.
//
// Replaces the TPU kernels
//   hpccg_tpu/ops/pallas/megakernel.py:_kernel (:119) and _kernel_slab (:193)
//     (K5, backend `megakernel`: RECOMPUTE_AP = false)
//   hpccg_tpu/ops/pallas/streamkernel.py:_kernel (:92)
//     (K6, backend `streamkernel`: RECOMPUTE_AP = true)
// Both run the entire CG solve in one launch: the host enqueues one kernel
// per solve and reads the result back once.
//
//   init:  x = x0; p = x0; r = b - A x0; rtrans = r.r        (one pass)
//   body k (while k < max_iter and normr > tol):
//     A: p' = r + beta p (formed as it is staged), Ap' = A p', partial of
//        p'.Ap'  -- grid sync -- alpha = rtrans / p'.Ap'
//     B: x += alpha p', r -= alpha Ap', partial of the new r.r
//        -- grid sync -- k+1, beta, normr, trace[k], the exit test
// The exit test uses the normr of the previous body's top, as the
// reference loop and fused_cg.cu's finalize step do (solver.py:94-137).
// The TPU kernels' whole and slab modes differ only in how they fit VMEM
// (megakernel.py:49-70); on Hopper they are this one kernel.
//
// K6 never materialises Ap: phase A writes p' and the partial only, and
// phase B recomputes A p' from p' (with its halo) to update r. The state is
// x, r and two p buffers: about 8 vector passes per iteration against 10
// for K5 and for K3+K4 (pallas_fused). This is K6's trade, made on the TPU
// to fit VMEM (streamkernel.py:9-14); here it saves bandwidth.
//
// bf16 state (T = __nv_bfloat16, S = float): vectors are stored in bf16,
// computed in f32 and stored with __float2bfloat16 (round to nearest even,
// as torch's .to(bfloat16)). The partials, the scalars and the trace are
// f32, so niters stays exact past 256 (megakernel.py:133-138, :339-341).
// The rounding points: p' is rounded to T as it is formed (so Ap' = A of
// the stored p'), Ap' is rounded when K5 stores it, r and x are rounded
// when stored; p'.Ap' uses the unrounded f32 A p'. p' = r + beta p, x +=
// alpha p' and r -= alpha Ap' are rounded one operation at a time (no FMA
// contraction). The plain torch versions (ops/cuda/wholesolve.py) round at
// the same places.
//
// What bounds it on this card. At 256^3 f32 a pass over one vector is
// 67 MB: K6's 8 passes are 537 MB per iteration, ~160 us at 3.35 TB/s,
// K5's 10 passes ~200 us; bf16 halves both. Its first form marched a tile
// of one 4-byte load per thread and staged element, one plane in flight
// and two barriers a plane, and was bound by loads in
// flight: half the bytes bought bf16 K5 only 10%. At 100^3 the state
// (5 vectors, 20 MB in f32) fits the 50 MB L2; the two grid syncs with
// their partial sums take about a quarter of an iteration there (PERF.md).
//
// What the design does about it:
//   - The phases march K3's staged tile (stencil_stage.cuh, shared with
//     stencil.cu): 16 bytes of a row a thread, a tile of 32 V x TY points,
//     z-planes staged by cp.async in a ring with one barrier a plane. init
//     is K1's body on x0, phase A K3's (r and p staged, p' formed once per
//     staged chunk), K6's phase B K1's on p'; their emits read and write
//     the vectors on 16-byte accesses. K5's phase B is K4's update
//     (cg_update.cuh) on the same tiles' rows, plane by plane, so that its
//     r.r has the same per-plane partials as the other phases' dots.
//   - One persistent cooperative launch (cudaLaunchCooperativeKernel): the
//     grid is min(occupancy, ws_blocks<T>()) blocks on each SM, capped by
//     the work items (x-tile, y-tile, z-chunk), which the blocks take in
//     turns in a fixed order. The z chunk is the one of WS_ZC, WS_ZC/2,
//     ..., 1 whose busiest block stages the fewest planes. A refused
//     cooperative launch is an error; nothing falls back.
//   - Everything written by other blocks earlier in the launch (r, p, Ap,
//     the partials) is read through L2 (cp.async.cg, __ldcg), never
//     through a possibly stale L1 line.
//   - p is double-buffered: phase A of one tile reads the old p in its
//     neighbours' halo while they write p'.
//   - The dot products have the TPU kernels' form, a partial per z-slab
//     added in S along z (streamkernel.py:164, :234; megakernel.py:235),
//     with a slab of one plane: each plane's products, rounded to S, are
//     added in double and the plane's sum is rounded to S once, so it does
//     not depend on the order of its terms (but for ties closer than about
//     1e-15 of it); the plane sums are added in S in z order. The plain
//     version (ops/cuda/wholesolve.py) computes the same on the CPU and on
//     the card, so kernel and plain version take the same scalars. That
//     matters for bf16: a stagnating bf16 recurrence turns a last-bit
//     difference of alpha into x elements rounded the other way, and with
//     float32 sums in another order the plain version parts from itself
//     (on an H100 against the CPU) in up to 14% of x within 30 iterations
//     (PERF.md).
//   - Deterministic and uniform scalars: for each plane of an item, the
//     warps' partials (shuffles) are added in a fixed order and written to
//     parts[tile][z]. Where they are few (nz x tiles <= WS_DIRECT, as at
//     100^3), after the grid sync every block adds each plane's tiles in
//     tile order (a plane a thread) and the nz plane sums in z order. Past
//     that (at 256^3 in f32 every block would read 128 KB a dot) the item
//     that completes its z chunk (an integer ticket per chunk, no float
//     atomics) adds the chunk's planes over the tiles in a fixed order and
//     writes the plane sums, and every block reads the nz sums. Each is
//     the faster at its size (PERF.md). Every block therefore holds
//     bit-identical scalars and takes the same exit decision, which it
//     must: a block that left the loop while others wait at the grid sync
//     would hang the card. Two solves are bit-identical.
//   - Block 0 writes trace[k] as it goes and the final scalar state (sc,
//     ic: the layout of cg_scalars.cuh) at the end, so the host builds the
//     result as for the per-iteration backends.
//   - Offsets into the vectors are 64-bit. b and x0 may be views at any
//     element offset: init stages and reads them on the widest access that
//     divides their pointers too; the loop keeps its own (16 bytes for
//     vectors the wrapper allocates, where nx * sizeof(T) allows).
//
// WS_ZC, the blocks per SM (HPCCG_WS_BLOCKS, HPCCG_WS_BLOCKS_BF16) and
// WS_DIRECT are compile-time constants, chosen by measurement on an H100
// (scripts/wholesolve_sweep.py, PERF.md); each can be set with a -D define
// of its HPCCG_WS_* name. HPCCG_WS_SYNC_ONLY=1 builds a variant whose
// phases do no vector work (the grid syncs and the partial sums alone,
// max_iter iterations whatever the residual), to time that fixed cost;
// only that script sets it.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <limits.h>

#include "cg_scalars.cuh"
#include "cg_update.cuh"
#include "reduce.cuh"
#include "stencil_stage.cuh"
#include "storage.cuh"

#ifndef HPCCG_WS_ZC
#define HPCCG_WS_ZC 32
#endif
#ifndef HPCCG_WS_BLOCKS
#define HPCCG_WS_BLOCKS 4
#endif
#ifndef HPCCG_WS_BLOCKS_BF16
#define HPCCG_WS_BLOCKS_BF16 2
#endif
#ifndef HPCCG_WS_SYNC_ONLY
#define HPCCG_WS_SYNC_ONLY 0
#endif
#ifndef HPCCG_WS_DIRECT
#define HPCCG_WS_DIRECT 4096
#endif

namespace {

namespace coop = cooperative_groups;
using namespace hpccg;
using namespace hpccg::stage;

constexpr int WS_ZC = HPCCG_WS_ZC;          // z-planes per work item, at most
constexpr bool SYNC_ONLY = HPCCG_WS_SYNC_ONLY != 0;
constexpr long long WS_DIRECT = HPCCG_WS_DIRECT;  // (tile, plane) partials a block adds itself, at most
// a plane's partials: its products rounded to S and added in double
using Acc = double;
// the ring: two staged inputs in phase A, one in init and K6's phase B
constexpr int WS_SMEM = ring_bytes(2) > ring_bytes(1) ? ring_bytes(2) : ring_bytes(1);
static_assert(WS_ZC >= 1 && HPCCG_WS_BLOCKS >= 1 && HPCCG_WS_BLOCKS_BF16 >= 1, "whole-solve constants");

// Resident blocks per SM, at most (the kernel's launch bound): fewer for
// bf16, whose 8 points a thread need more registers.
template <typename T>
__host__ __device__ constexpr int ws_blocks() {
  return sizeof(T) == 2 ? HPCCG_WS_BLOCKS_BF16 : HPCCG_WS_BLOCKS;
}

template <typename T, typename S>
struct Params {
  const T* b;
  const T* x0;
  T* x;
  T* r;
  T* p0;
  T* p1;
  T* ap;          // K5 only (null for K6)
  double* parts;  // per dot (p'.Ap', r.r): tiles x nz plane partials, then the nz plane sums
  int* tickets;   // per dot and z chunk: the items that wrote their partials (0 between dots)
  S* sc;
  int* ic;
  S* trace;
  int nx, ny, nz;
  int zc;           // z-planes per work item
  int access;       // bytes per access of x, r, p0, p1, ap
  int init_access;  // the same, of b and x0 too
  int direct;       // every block adds all (tile, plane) partials itself (no tickets)
};

__host__ __device__ __forceinline__ int ceil_div(int a, int b) { return (a + b - 1) / b; }

// A thread's V points on one output row: the offset of the first, how many
// lie inside the grid (<= 0: none), and whether they are one 16-byte access.
struct Pts {
  int64_t o;
  int count;
  bool wide;
};

template <typename T, typename S>
__device__ __forceinline__ void load_pts(const T* p, const Pts& at, S (&v)[Geo<T>::V]) {
  constexpr int V = Geo<T>::V;
  if (at.wide) {
    const uint4 q = ldcg(reinterpret_cast<const uint4*>(p + at.o));
    const T* e = reinterpret_cast<const T*>(&q);
#pragma unroll
    for (int j = 0; j < V; ++j) v[j] = to_s(e[j]);
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) v[j] = j < at.count ? to_s(ldcg(p + at.o + j)) : S(0);
  }
}

template <typename T>
__device__ __forceinline__ void store_pts(T* p, const Pts& at, const T (&v)[Geo<T>::V]) {
  constexpr int V = Geo<T>::V;
  if (at.wide) {
    *reinterpret_cast<uint4*>(p + at.o) = *reinterpret_cast<const uint4*>(v);
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      if (j < at.count) p[at.o + j] = v[j];
    }
  }
}

enum { DOT_PAP = 0, DOT_RR = 1 };

// Plane z's partials of `tiles` tiles, part[0][z], part[1][z], ... (written
// by other blocks in this launch: read through L2), added in tile order in
// double with 16 loads in flight: the read of the direct path. Not
// inlined, so that its loads in flight do not take registers from the
// marches, which run at the launch bound.
__device__ __noinline__ double add_tiles(const double* part, int tiles, int nz) {
  constexpr int BATCH = 16;
  double t = 0;
  for (int i0 = 0; i0 < tiles; i0 += BATCH) {
    double v[BATCH];
#pragma unroll
    for (int j = 0; j < BATCH; ++j) v[j] = i0 + j < tiles ? __ldcg(part + (int64_t)(i0 + j) * nz) : 0.0;
#pragma unroll
    for (int j = 0; j < BATCH; ++j) t += v[j];
  }
  return t;
}

template <typename T, typename S, int STENCIL, bool RECOMPUTE_AP>
__global__ void __launch_bounds__(NT, ws_blocks<T>()) wholesolve_kernel(const __grid_constant__ Params<T, S> P) {
  constexpr int V = Geo<T>::V, TX = Geo<T>::TX;
  coop::grid_group grid = coop::this_grid();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);
  __shared__ Acc red[TY][WS_ZC];  // the warps' partials of an item's planes
  __shared__ Acc red_g[NT];       // the last item's sums of groups of tiles, by plane
  __shared__ S sums[NT];          // plane sums, added in z order by thread 0
  __shared__ S total;
  __shared__ int last;            // this item completed its z chunk

  const int nx = P.nx, ny = P.ny, nz = P.nz;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int tiles_x = ceil_div(nx, TX), tiles = tiles_x * ceil_div(ny, TY);
  const int chunks = ceil_div(nz, P.zc);
  const int items = tiles * chunks;
  const int64_t plane = (int64_t)nx * ny;
  const int64_t dot_stride = (int64_t)nz * (tiles + 1);  // doubles of P.parts per dot
  const bool leader = blockIdx.x == 0 && threadIdx.x == 0;
  const Extent ext{nx, ny, nz, P.access};
  const Extent ext0{nx, ny, nz, P.init_access};
  const Planes<T> none{nullptr, nullptr, nullptr};

  // Warp w's partial of plane z (of the item's planes from z0): every lane
  // calls it with its own sum.
  auto plane_part = [&](int z, int z0, Acc v) {
    v = warp_sum(v);
    if (lane == 0) red[w][z - z0] = v;
  };
  // After an item of dot d: its tile's plane partials (the warps in order)
  // to parts[tile][z]. Where every block adds them itself (P.direct), that
  // is all. Else the item that completes its z chunk adds the chunk's
  // planes over the tiles in a fixed order and writes the plane sums,
  // rounded to S: published as cooperative groups' grid sync publishes
  // (the block's barrier, then thread 0 fences and takes a ticket, an
  // integer atomic); the last item fences again and reads through L2.
  auto finish_item = [&](int d, int tile, int cz, int z0, int z1) {
    double* part = P.parts + d * dot_stride;
    const int nzc = z1 - z0;
    __syncthreads();  // red is complete; the ring's reads are done
    if (threadIdx.x < nzc) {
      Acc t = red[0][threadIdx.x];
#pragma unroll
      for (int i = 1; i < TY; ++i) t += red[i][threadIdx.x];
      part[(int64_t)tile * nz + z0 + threadIdx.x] = t;
    }
    __syncthreads();  // red is read: the next item may write it
    if (P.direct) return;
    int* ticket = P.tickets + d * chunks + cz;
    if (threadIdx.x == 0) {
      __threadfence();
      last = atomicAdd(ticket, 1) == tiles - 1;
      if (last) __threadfence();
    }
    __syncthreads();
    if (last) {
      // thread t adds tiles g, g + groups, ... of plane z0 + t % nzc (g = t / nzc) ...
      const int groups = min(NT / nzc, tiles), z = threadIdx.x % nzc, g = threadIdx.x / nzc;
      if (g < groups) {
        Acc t = 0;
#pragma unroll 4
        for (int i = g; i < tiles; i += groups) t += __ldcg(part + (int64_t)i * nz + z0 + z);
        red_g[g * nzc + z] = t;
      }
      __syncthreads();
      // ... and thread z adds the groups in order
      if (threadIdx.x < nzc) {
        Acc t = red_g[threadIdx.x];
        for (int i = 1; i < groups; ++i) t += red_g[i * nzc + threadIdx.x];
        part[(int64_t)tiles * nz + z0 + threadIdx.x] = (double)S(t);
      }
      if (threadIdx.x == 0) *ticket = 0;  // for the next time this dot is summed
    }
  };
  // Dot d once every item has finished: the plane sums (P.direct: each
  // plane's tiles added in tile order, a plane a thread) added in S in z
  // order by thread 0; every thread of every block gets the same bits.
  auto dot_total = [&](int d) -> S {
    grid.sync();
    const double* part = P.parts + d * dot_stride;
    S acc = S(0);
    for (int base = 0; base < nz; base += NT) {
      const int m = min(NT, nz - base), z = base + threadIdx.x;
      if (threadIdx.x < m) {
        sums[threadIdx.x] = S(P.direct ? add_tiles(part + z, tiles, nz) : __ldcg(part + (int64_t)tiles * nz + z));
      }
      __syncthreads();
      if (threadIdx.x == 0) {
#pragma unroll 8
        for (int i = 0; i < m; ++i) acc = add_rn(acc, sums[i]);
      }
      __syncthreads();
    }
    if (threadIdx.x == 0) total = acc;
    __syncthreads();
    return total;
  };
  // Run body(bx0, by0, z0, z1) for each of this block's work items, in a
  // fixed order, each followed by finish_item for dot d.
  auto for_items = [&](int d, auto&& body) {
    for (int it = blockIdx.x; it < items; it += gridDim.x) {
      const int cz = it / tiles, tile = it % tiles;
      const int z0 = cz * P.zc, z1 = min(z0 + P.zc, nz);
      if (!SYNC_ONLY) body((tile % tiles_x) * TX, (tile / tiles_x) * TY, z0, z1);
      finish_item(d, tile, cz, z0, z1);
    }
  };
  // The thread's points on output plane z of the tile at (bx0, by0), for
  // accesses of `access` bytes.
  auto pts = [&](int bx0, int by0, int z, int access) {
    const int ix0 = bx0 + lane * V, iy = by0 + w;
    const int count = iy < ny ? min(V, nx - ix0) : 0;
    return Pts{(int64_t)z * plane + (int64_t)iy * nx + ix0, count, count == V && access == 16};
  };

  // ---- init: x = x0; p = x0; r = b - A x0; r.r ----
  for_items(DOT_RR, [&](int bx0, int by0, int z0, int z1) {
    march<T, S, STENCIL, 1, false, true>(
        ring, {P.x0, nullptr, nullptr}, none, ext0, S(0), bx0, by0, z0, z1,
        [&](int z, const S(&c)[V], const S(&y)[V]) {
          const Pts at = pts(bx0, by0, z, P.access);
          Acc part = 0;
          if (at.count > 0) {
            S bv[V];
            load_pts<T, S>(P.b, pts(bx0, by0, z, P.init_access), bv);
            alignas(16) T xt[V];
            alignas(16) T rt[V];
#pragma unroll
            for (int j = 0; j < V; ++j) {
              xt[j] = from_s<T>(c[j]);
              rt[j] = from_s<T>(bv[j] - y[j]);
              const S rs = to_s(rt[j]);
              if (j < at.count) part += Acc(mul_rn(rs, rs));
            }
            store_pts<T>(P.x, at, xt);
            store_pts<T>(P.p0, at, xt);
            store_pts<T>(P.r, at, rt);
          }
          plane_part(z, z0, part);
        });
  });
  S rt_cur = dot_total(DOT_RR);
  S rt_prev = rt_cur;
  S normr = sqrt(rt_cur);
  const S tol = P.sc[SC_TOL];
  const int max_iter = P.ic[IC_MAX_ITER];
  int k = 1;
  if (leader) P.trace[0] = normr;
  bool go = k < max_iter && (SYNC_ONLY || normr > tol);
  S beta = S(0);  // k == 1: p = r
  if (go && leader) P.trace[k] = normr;

  T* p_old = P.p0;
  T* p_new = P.p1;
  while (go) {
    // ---- phase A: p' = r + beta p, Ap' = A p', partial of p'.Ap' ----
    for_items(DOT_PAP, [&](int bx0, int by0, int z0, int z1) {
      march<T, S, STENCIL, 2, true, true>(
          ring, {P.r, nullptr, nullptr}, {p_old, nullptr, nullptr}, ext, beta, bx0, by0, z0, z1,
          [&](int z, const S(&c)[V], const S(&y)[V]) {
            const Pts at = pts(bx0, by0, z, P.access);
            Acc part = 0;
            if (at.count > 0) {
              alignas(16) T pt[V];
              alignas(16) T yt[V];
#pragma unroll
              for (int j = 0; j < V; ++j) {
                pt[j] = from_s<T>(c[j]);
                yt[j] = from_s<T>(y[j]);
                if (j < at.count) part += Acc(mul_rn(c[j], y[j]));
              }
              store_pts<T>(p_new, at, pt);
              if (!RECOMPUTE_AP) store_pts<T>(P.ap, at, yt);
            }
            plane_part(z, z0, part);
          });
    });
    const S alpha = rt_cur / dot_total(DOT_PAP);

    // ---- phase B: x += alpha p', r -= alpha Ap', partial of the new r.r ----
    if (RECOMPUTE_AP) {
      for_items(DOT_RR, [&](int bx0, int by0, int z0, int z1) {
        march<T, S, STENCIL, 1, false, true>(
            ring, {p_new, nullptr, nullptr}, none, ext, S(0), bx0, by0, z0, z1,
            [&](int z, const S(&c)[V], const S(&y)[V]) {
              const Pts at = pts(bx0, by0, z, P.access);
              Acc part = 0;
              if (at.count > 0) {
                S rv[V], xv[V];
                load_pts<T, S>(P.r, at, rv);
                load_pts<T, S>(P.x, at, xv);
                alignas(16) T rt[V];
                alignas(16) T xt[V];
#pragma unroll
                for (int j = 0; j < V; ++j) {
                  rt[j] = from_s<T>(add_rn(rv[j], -mul_rn(alpha, y[j])));
                  xt[j] = from_s<T>(add_rn(xv[j], mul_rn(alpha, c[j])));
                  const S rs = to_s(rt[j]);
                  if (j < at.count) part += Acc(mul_rn(rs, rs));
                }
                store_pts<T>(P.r, at, rt);
                store_pts<T>(P.x, at, xt);
              }
              plane_part(z, z0, part);
            });
      });
    } else {
      // K4's update (cg_update.cuh) on the tile's rows, one plane at a time
      for_items(DOT_RR, [&](int bx0, int by0, int z0, int z1) {
        for (int z = z0; z < z1; ++z) {
          const Pts at = pts(bx0, by0, z, P.access);
          Acc part = 0;
          if (at.wide) {
            uint4* xq = reinterpret_cast<uint4*>(P.x + at.o);
            uint4* rq = reinterpret_cast<uint4*>(P.r + at.o);
            uint4 xv = ldcg(xq), rv = ldcg(rq);
            const uint4 pv = ldcg(reinterpret_cast<const uint4*>(p_new + at.o));
            const uint4 av = ldcg(reinterpret_cast<const uint4*>(P.ap + at.o));
            update_vec<T, S, Acc>(xv, rv, pv, av, alpha, part);
            *xq = xv;
            *rq = rv;
          } else {
            for (int j = 0; j < at.count; ++j) {
              const int64_t i = at.o + j;
              T xi = ldcg(P.x + i), ri = ldcg(P.r + i);
              update_one<T, S, Acc>(xi, ri, ldcg(p_new + i), ldcg(P.ap + i), alpha, part);
              P.x[i] = xi;
              P.r[i] = ri;
            }
          }
          plane_part(z, z0, part);
        }
      });
    }
    // ---- the end of body k: the top of body k+1 ----
    rt_prev = rt_cur;
    rt_cur = dot_total(DOT_RR);
    ++k;
    go = k < max_iter && (SYNC_ONLY || normr > tol);
    if (go) {
      beta = rt_cur / rt_prev;
      normr = sqrt(rt_cur);
      if (leader) P.trace[k] = normr;
    }
    T* t = p_old;
    p_old = p_new;
    p_new = t;
  }
  if (leader) {  // the state fused_cg.cu's finalize step leaves at the exit
    P.sc[SC_RT_CUR] = rt_cur;
    P.sc[SC_RT_PREV] = rt_prev;
    P.sc[SC_ALPHA] = S(0);
    P.sc[SC_BETA] = S(0);
    P.sc[SC_NORMR] = normr;
    P.ic[IC_K] = k;
    P.ic[IC_ACTIVE] = 0;
  }
}

template <typename T, typename S>
const void* kernel_for(int stencil, int recompute_ap) {
  if (stencil == 27) {
    return recompute_ap ? (const void*)wholesolve_kernel<T, S, 27, true>
                        : (const void*)wholesolve_kernel<T, S, 27, false>;
  }
  return recompute_ap ? (const void*)wholesolve_kernel<T, S, 7, true>
                      : (const void*)wholesolve_kernel<T, S, 7, false>;
}

// The cooperative grid of a solve: its z chunk, work items and blocks.
struct Geometry {
  int zc;
  int items;
  int blocks;
};

// The geometry of an nx*ny*nz solve on the current device: every block
// resident at once (min(occupancy, ws_blocks<T>()) on each SM), capped by the
// work items; of the z chunks WS_ZC, WS_ZC/2, ..., 1 the one whose busiest
// block stages the fewest planes (ceil(items / blocks) items of zc + 2
// planes), the larger on a tie. Returns a CUDA error code.
template <typename T, typename S>
int geometry(int nx, int ny, int nz, int stencil, int recompute_ap, Geometry* g) {
  if ((stencil != 27 && stencil != 7) || nx < 1 || ny < 1 || nz < 1) return (int)cudaErrorInvalidValue;
  const void* kern = kernel_for<T, S>(stencil, recompute_ap);
  int dev = 0, sms = 0, coop_ok = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop_ok, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess && WS_SMEM > 48 * 1024) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, WS_SMEM);
  }
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, NT, WS_SMEM);
  if (err != cudaSuccess) return (int)err;
  if (!coop_ok || per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  const long long resident = (long long)(per_sm < ws_blocks<T>() ? per_sm : ws_blocks<T>()) * sms;
  const long long tiles = (long long)ceil_div(nx, Geo<T>::TX) * ceil_div(ny, TY);
  long long best = LLONG_MAX, items = 0, blocks = 0;
  for (int zc = WS_ZC; zc >= 1; zc /= 2) {
    const long long it = tiles * ceil_div(nz, zc);
    const long long bl = it < resident ? it : resident;
    const long long cost = (it + bl - 1) / bl * (zc + 2);
    if (cost < best) {
      best = cost;
      g->zc = zc;
      items = it;
      blocks = bl;
    }
  }
  if (items > INT_MAX) return (int)cudaErrorInvalidValue;
  g->items = (int)items;
  g->blocks = (int)blocks;
  return (int)cudaSuccess;
}

template <typename T, typename S>
int launch_wholesolve(const T* b, const T* x0, T* x, T* r, T* p0, T* p1, T* ap, double* parts,
                      long long nparts, int* tickets, int ntickets, S* sc, int* ic, S* trace, int nx,
                      int ny, int nz, int stencil, int recompute_ap, void* stream) {
  Geometry g;
  const int err = geometry<T, S>(nx, ny, nz, stencil, recompute_ap, &g);
  if (err != (int)cudaSuccess) return err;
  const long long tiles = (long long)ceil_div(nx, Geo<T>::TX) * ceil_div(ny, TY);
  if (nparts < 2LL * nz * (tiles + 1) || ntickets < 2 * ceil_div(nz, g.zc) ||
      (!recompute_ap && ap == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const void* ptrs[] = {x, r, p0, p1, ap, b, x0};
  const int esize = (int)sizeof(T);
  const int access = access_bytes(nx, esize, ptrs, 5), init_access = access_bytes(nx, esize, ptrs, 7);
  if (init_access < esize) return (int)cudaErrorMisalignedAddress;
  const int direct = (long long)nz * tiles <= WS_DIRECT;
  Params<T, S> params{b,  x0,    x,  r,  p0, p1,   ap,     parts,       tickets, sc,
                      ic, trace, nx, ny, nz, g.zc, access, init_access, direct};
  void* args[] = {&params};
  return (int)cudaLaunchCooperativeKernel(kernel_for<T, S>(stencil, recompute_ap), dim3(g.blocks), dim3(NT),
                                          args, WS_SMEM, (cudaStream_t)stream);
}

template <typename T, typename S>
int geometry_out(int nx, int ny, int nz, int stencil, int recompute_ap, int* out) {
  Geometry g;
  const int err = geometry<T, S>(nx, ny, nz, stencil, recompute_ap, &g);
  if (err != (int)cudaSuccess) return err;
  out[0] = Geo<T>::TX;
  out[1] = TY;
  out[2] = g.zc;
  out[3] = g.items;
  out[4] = g.blocks;
  return 0;
}

}  // namespace

extern "C" {

// The cooperative grid of an nx*ny*nz solve on the current device: out =
// {tile width, tile height, z-planes per work item, work items, blocks}.
// The launch takes 2 nz (tiles + 1) doubles of partials and 2 ceil(nz /
// zc) zeroed tickets, tiles = ceil(nx / width) ceil(ny / height). dtype: 0
// float32, 1 float64, 2 bfloat16. Returns a CUDA error code.
int hpccg_wholesolve_geometry(int nx, int ny, int nz, int dtype, int stencil, int recompute_ap, int* out) {
  if (dtype == 0) return geometry_out<float, float>(nx, ny, nz, stencil, recompute_ap, out);
  if (dtype == 1) return geometry_out<double, double>(nx, ny, nz, stencil, recompute_ap, out);
  if (dtype == 2) return geometry_out<__nv_bfloat16, float>(nx, ny, nz, stencil, recompute_ap, out);
  return (int)cudaErrorInvalidValue;
}

int hpccg_wholesolve_f32(const float* b, const float* x0, float* x, float* r, float* p0, float* p1,
                         float* ap, double* parts, long long nparts, int* tickets, int ntickets,
                         float* sc, int* ic, float* trace, int nx, int ny, int nz, int stencil,
                         int recompute_ap, void* stream) {
  return launch_wholesolve<float, float>(b, x0, x, r, p0, p1, ap, parts, nparts, tickets, ntickets, sc,
                                         ic, trace, nx, ny, nz, stencil, recompute_ap, stream);
}

int hpccg_wholesolve_f64(const double* b, const double* x0, double* x, double* r, double* p0,
                         double* p1, double* ap, double* parts, long long nparts, int* tickets,
                         int ntickets, double* sc, int* ic, double* trace, int nx, int ny, int nz,
                         int stencil, int recompute_ap, void* stream) {
  return launch_wholesolve<double, double>(b, x0, x, r, p0, p1, ap, parts, nparts, tickets, ntickets,
                                           sc, ic, trace, nx, ny, nz, stencil, recompute_ap, stream);
}

int hpccg_wholesolve_bf16(const __nv_bfloat16* b, const __nv_bfloat16* x0, __nv_bfloat16* x,
                          __nv_bfloat16* r, __nv_bfloat16* p0, __nv_bfloat16* p1,
                          __nv_bfloat16* ap, double* parts, long long nparts, int* tickets,
                          int ntickets, float* sc, int* ic, float* trace, int nx, int ny, int nz,
                          int stencil, int recompute_ap, void* stream) {
  return launch_wholesolve<__nv_bfloat16, float>(b, x0, x, r, p0, p1, ap, parts, nparts, tickets,
                                                 ntickets, sc, ic, trace, nx, ny, nz, stencil,
                                                 recompute_ap, stream);
}

}  // extern "C"
