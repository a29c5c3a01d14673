// The staged-plane stencil tile of the Hopper kernels: the per-iteration
// stencil kernels K1-K3 and K7 (stencil.cu), the whole-solve kernels K5
// and K6 (wholesolve.cu) and the collective whole solves K15 and K16
// (collective.cu) march it.
//
// A is the implicit generated-problem operator: A u = 28 u - S(u), where S
// is the boundary-clipped 27-point (or 7-point) neighbour sum including the
// point itself. Vectors are the flat row-major (nz, ny, nx) layout of the
// JAX package (currow = iz*nx*ny + iy*nx + ix), with no padding.
//
// The tile: a thread owns V consecutive x points, one 16-byte access of
// each array (V = 4 in f32, 8 in bf16, 2 in f64); a warp spans 32 V
// columns and a block is TY warps, one output row each, so a tile is
// 32 V x TY. march() walks one tile over a chunk of z-planes. Each input
// plane of the tile, with a one-row apron in y and a 16-byte apron vector
// on each side in x, is staged in shared memory by cp.async into a ring of
// planes; the next planes are in flight while plane zz is summed, with one
// block barrier per plane. The xy-sum of a plane stays in registers for
// the next two planes; the x neighbours come from the neighbouring lanes
// by shuffles. With FUSE_P each thread forms p' = r + beta p (rounded to
// T, one operation at a time) over the staged chunks it copied itself,
// before the plane's barrier, in place of r.
//
// Access width: a vector may be a view at any element offset. The widest
// access of 16, 8, 4 (or 2, bf16) bytes that divides every pointer and the
// row pitch nx * sizeof(T) (access_bytes) is taken for a whole march, so
// that no chunk straddles the grid's edge. A kernel that reads planes
// written by other blocks earlier in the same launch (the whole solves)
// stages with L2 = true: 16-byte chunks by cp.async.cg and narrower ones
// by __ldcg loads, never through a possibly stale L1 line.
//
// TY and NSTAGE are compile-time constants, chosen by measurement on an
// H100 (scripts/stencil_tile_sweep.py, PERF.md); each can be set with a -D
// define of its HPCCG_STENCIL_* name.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "reduce.cuh"
#include "storage.cuh"

#ifndef HPCCG_STENCIL_TY
#define HPCCG_STENCIL_TY 8
#endif
#ifndef HPCCG_STENCIL_NSTAGE
#define HPCCG_STENCIL_NSTAGE 3
#endif

namespace hpccg {
namespace stage {

constexpr int TY = HPCCG_STENCIL_TY;          // warps per block, one output row each
constexpr int NT = 32 * TY;                   // threads per block
constexpr int NSTAGE = HPCCG_STENCIL_NSTAGE;  // staged planes in the ring of one input
constexpr int ROWS = TY + 2;                  // staged rows: the tile's and its y-apron
constexpr int ROW_BYTES = 34 * 16;  // staged row: 32 lanes' vectors and an apron vector each side
static_assert(NT <= 1024 && NSTAGE >= 2, "stencil tile constants");

// Ring slots for NA staged inputs: a ring of two inputs (r and p) is one
// slot shorter than one input's, so that about the same bytes are in
// flight per block (the faster of the two in f32 on an H100; PERF.md).
__host__ __device__ constexpr int ring_slots(int na) { return na == 1 ? NSTAGE : (NSTAGE > 2 ? NSTAGE - 1 : 2); }

// Shared-memory bytes of a ring of NA inputs (the same for every T: a
// staged plane is ROWS x ROW_BYTES).
__host__ __device__ constexpr int ring_bytes(int na) { return ring_slots(na) * na * ROWS * ROW_BYTES; }

template <typename T>
struct Geo {
  static constexpr int V = 16 / (int)sizeof(T);  // points per thread
  static constexpr int TX = 32 * V;              // tile width
  static constexpr int ROW = ROW_BYTES / (int)sizeof(T);
  static constexpr int PLANE = ROWS * ROW;  // elements of one staged plane
};

// One staged input: its planes 0 .. nz-1, and the planes -1 and nz (null
// at the domain boundary: zero).
template <typename T>
struct Planes {
  const T* base;
  const T* below;
  const T* above;
};

struct Extent {
  int nx, ny, nz;
  int access;  // bytes per access: 16, 8, 4 or 2
};

// The widest access (16, 8, 4 or 2 bytes) that divides the row pitch and
// every pointer.
inline int access_bytes(int nx, int esize, const void* const* ptrs, int n) {
  uintptr_t m = (uintptr_t)16 | ((uintptr_t)nx * (uintptr_t)esize);
  for (int i = 0; i < n; ++i) m |= (uintptr_t)ptrs[i];
  return (int)(m & (~m + 1));
}

// ------------------------------------------------------------ async copies

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// One staged chunk of `bytes` bytes: cp.async.cg for 16 bytes (L2 only);
// for 8 and 4 bytes cp.async.ca, or with L2 an __ldcg load and a shared
// store; for 2 bytes a load and a store (cp.async copies at least 4).
template <bool L2>
__device__ __forceinline__ void copy_chunk(void* dst, const void* src, int bytes) {
  if (bytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src) : "memory");
  } else if (L2) {
    if (bytes == 8) {
      *reinterpret_cast<uint2*>(dst) = __ldcg(reinterpret_cast<const uint2*>(src));
    } else if (bytes == 4) {
      *reinterpret_cast<unsigned*>(dst) = __ldcg(reinterpret_cast<const unsigned*>(src));
    } else {
      *reinterpret_cast<unsigned short*>(dst) = __ldcg(reinterpret_cast<const unsigned short*>(src));
    }
  } else if (bytes == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(smem_addr(dst)), "l"(src) : "memory");
  } else if (bytes == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src) : "memory");
  } else {
    *reinterpret_cast<uint16_t*>(dst) = *reinterpret_cast<const uint16_t*>(src);
  }
}

__device__ __forceinline__ void zero_chunk(void* dst, int bytes) {
  if (bytes == 16) {
    *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
  } else if (bytes == 8) {
    *reinterpret_cast<uint2*>(dst) = make_uint2(0, 0);
  } else if (bytes == 4) {
    *reinterpret_cast<uint32_t*>(dst) = 0;
  } else {
    *reinterpret_cast<uint16_t*>(dst) = 0;
  }
}

__device__ __forceinline__ void commit_group() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ------------------------------------------------------------ staging

// Where row gy, column gx of plane zz of one input lives: null outside the
// grid or on a missing halo plane.
template <typename T>
__device__ __forceinline__ const T* source(const Planes<T>& in, int zz, int gy, int gx, const Extent& e) {
  if (gy < 0 || gy >= e.ny || gx < 0 || gx >= e.nx) return nullptr;
  const T* plane = zz < 0 ? in.below : (zz >= e.nz ? in.above : in.base + (int64_t)zz * e.ny * e.nx);
  return plane == nullptr ? nullptr : plane + (int64_t)gy * e.nx + gx;
}

// Chunk c of a staged plane: its row and its first element in the row.
// A row is ROW_BYTES / access chunks; every access width divides the
// apron vector, so a chunk lies wholly inside or wholly outside the grid
// (nx * sizeof(T) is a multiple of the access width too).
__device__ __forceinline__ void chunk_pos(int c, int access, int esize, int& ly, int& lx) {
  const int byte = c * access;
  ly = byte / ROW_BYTES;
  lx = (byte - ly * ROW_BYTES) / esize;
}

// Start the copies of plane zz of the NA inputs u (and v) into `slot` (NA
// planes of Geo<T>::PLANE elements). Each thread takes chunks tid, tid +
// NT, ...; the same chunks in every input, so that it can form p' over
// them.
template <typename T, int NA, bool L2>
__device__ __forceinline__ void stage_plane(T* slot, const Planes<T>& u, const Planes<T>& v, const Extent& e,
                                            int zz, int bx0, int by0) {
  constexpr int V = Geo<T>::V;
  const int nchunks = ROWS * ROW_BYTES / e.access;
  for (int c = threadIdx.x; c < nchunks; c += NT) {
    int ly, lx;
    chunk_pos(c, e.access, (int)sizeof(T), ly, lx);
    const int gy = by0 + ly - 1, gx = bx0 - V + lx;
    const T* su = source(u, zz, gy, gx, e);
    T* du = slot + ly * Geo<T>::ROW + lx;
    if (su != nullptr) {
      copy_chunk<L2>(du, su, e.access);
    } else {
      zero_chunk(du, e.access);
    }
    if (NA == 2) {
      const T* sv = source(v, zz, gy, gx, e);
      T* dv = du + Geo<T>::PLANE;
      if (sv != nullptr) {
        copy_chunk<L2>(dv, sv, e.access);
      } else {
        zero_chunk(dv, e.access);
      }
    }
  }
}

// p' = r + beta p on one staged chunk of W bytes (one shared-memory access
// of each array a chunk, so that a warp's lanes take consecutive chunks
// without bank conflicts), rounded to T, in place of r.
template <typename T, typename S, typename W>
__device__ __forceinline__ void form_p_chunk(T* r, const T* p, S beta) {
  constexpr int N = (int)(sizeof(W) / sizeof(T));
  W rw = *reinterpret_cast<const W*>(r);
  const W pw = *reinterpret_cast<const W*>(p);
  T* re = reinterpret_cast<T*>(&rw);
  const T* pe = reinterpret_cast<const T*>(&pw);
#pragma unroll
  for (int e = 0; e < N; ++e) re[e] = from_s<T>(add_rn(to_s(re[e]), mul_rn(beta, to_s(pe[e]))));
  *reinterpret_cast<W*>(r) = rw;
}

// p' over the chunks of plane zz that this thread staged (its copies have
// landed). Chunks outside the grid stay 0.
template <typename T, typename S>
__device__ __forceinline__ void form_p(T* slot, const Planes<T>& u, const Extent& e, S beta, int zz, int bx0,
                                       int by0) {
  constexpr int V = Geo<T>::V;
  const int nchunks = ROWS * ROW_BYTES / e.access;
  for (int c = threadIdx.x; c < nchunks; c += NT) {
    int ly, lx;
    chunk_pos(c, e.access, (int)sizeof(T), ly, lx);
    const int gy = by0 + ly - 1, gx = bx0 - V + lx;
    if (source(u, zz, gy, gx, e) == nullptr) continue;
    T* r = slot + ly * Geo<T>::ROW + lx;
    const T* p = r + Geo<T>::PLANE;
    if (e.access == 16) {
      form_p_chunk<T, S, uint4>(r, p, beta);
    } else if (e.access == 8) {
      form_p_chunk<T, S, uint2>(r, p, beta);
    } else if (e.access == 4) {
      form_p_chunk<T, S, uint32_t>(r, p, beta);
    } else {
      form_p_chunk<T, S, uint16_t>(r, p, beta);
    }
  }
}

// ------------------------------------------------------------ the sums

// Row `row` of a staged plane as seen by lane `lane`: a[1 .. V] are its V
// points, a[0] and a[V+1] the neighbours left and right (from the next
// lanes, or the apron vectors at the ends of the warp).
template <typename T, typename S>
__device__ __forceinline__ void load_row(const T* row, int lane, S (&a)[Geo<T>::V + 2]) {
  constexpr int V = Geo<T>::V;
  const uint4 q = *reinterpret_cast<const uint4*>(row + V + lane * V);
  const T* e = reinterpret_cast<const T*>(&q);
#pragma unroll
  for (int j = 0; j < V; ++j) a[j + 1] = to_s(e[j]);
  S left = __shfl_up_sync(0xffffffffu, a[V], 1);
  S right = __shfl_down_sync(0xffffffffu, a[1], 1);
  if (lane == 0) left = to_s(row[V - 1]);
  if (lane == 31) right = to_s(row[V + Geo<T>::TX]);
  a[0] = left;
  a[V + 1] = right;
}

// The centre points c and the in-plane sums s of this thread's V points on
// one staged plane: sum3_y(sum3_x(u)) (27-point), associated as the JAX
// package's _axis_sum3, or the in-plane 5-point sum (7-point).
template <typename T, typename S, int STENCIL>
__device__ __forceinline__ void plane_sums(const T* plane, int w, int lane, S (&c)[Geo<T>::V],
                                           S (&s)[Geo<T>::V]) {
  constexpr int V = Geo<T>::V, ROW = Geo<T>::ROW;
  S a[V + 2];
  if (STENCIL == 27) {
    S xm[V], x0[V];
    load_row<T, S>(plane + w * ROW, lane, a);
#pragma unroll
    for (int j = 0; j < V; ++j) xm[j] = (a[j] + a[j + 1]) + a[j + 2];
    load_row<T, S>(plane + (w + 1) * ROW, lane, a);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      c[j] = a[j + 1];
      x0[j] = (a[j] + a[j + 1]) + a[j + 2];
    }
    load_row<T, S>(plane + (w + 2) * ROW, lane, a);
#pragma unroll
    for (int j = 0; j < V; ++j) s[j] = (xm[j] + x0[j]) + ((a[j] + a[j + 1]) + a[j + 2]);
  } else {
    load_row<T, S>(plane + (w + 1) * ROW, lane, a);
    const uint4 qu = *reinterpret_cast<const uint4*>(plane + w * ROW + V + lane * V);
    const uint4 qd = *reinterpret_cast<const uint4*>(plane + (w + 2) * ROW + V + lane * V);
    const T* up = reinterpret_cast<const T*>(&qu);
    const T* dn = reinterpret_cast<const T*>(&qd);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      c[j] = a[j + 1];
      s[j] = ((a[j] + a[j + 1]) + a[j + 2]) + (to_s(up[j]) + to_s(dn[j]));
    }
  }
}

// ------------------------------------------------------------ the march

// March the tile at (bx0, by0) over the output planes [z0, z1) of the NA
// inputs u (and v: p, with FUSE_P). `ring` is ring_bytes(NA) of shared
// memory. For each output plane z every thread calls emit(z, c, y): c its
// V centre points (u, or p' with FUSE_P) and y = A c there, in S; lanes
// and rows outside the grid are called too, and the caller drops them.
// Every thread of the block must call this (it synchronises the block);
// a caller that marches again must synchronise the block first (the ring
// is reused).
template <typename T, typename S, int STENCIL, int NA, bool FUSE_P, bool L2, typename Emit>
__device__ __forceinline__ void march(T* ring, const Planes<T>& u, const Planes<T>& v, const Extent& e, S beta,
                                      int bx0, int by0, int z0, int z1, Emit&& emit) {
  constexpr int V = Geo<T>::V, RING = ring_slots(NA);
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  auto slot = [&](int i) { return ring + (i % RING) * (NA * Geo<T>::PLANE); };

  // planes z0-1 .. z1: the first RING-1 in flight before the march
#pragma unroll
  for (int i = 0; i < RING - 1; ++i) {
    if (z0 - 1 + i <= z1) stage_plane<T, NA, L2>(slot(i), u, v, e, z0 - 1 + i, bx0, by0);
    commit_group();
  }
  // c: the thread's points on planes z-1, z; s: their in-plane sums there
  S c_prev[V], c_cur[V], s_prev[V], s_cur[V];
#pragma unroll
  for (int j = 0; j < V; ++j) c_prev[j] = c_cur[j] = s_prev[j] = s_cur[j] = S(0);
  for (int zz = z0 - 1, it = 0; zz <= z1; ++zz, ++it) {
    wait_group<RING - 2>();  // this thread's copies of plane zz have landed
    if (FUSE_P) form_p<T, S>(slot(it), u, e, beta, zz, bx0, by0);
    __syncthreads();  // plane zz is staged for all; plane zz-1's reads are done
    if (zz + RING - 1 <= z1) stage_plane<T, NA, L2>(slot(it + RING - 1), u, v, e, zz + RING - 1, bx0, by0);
    commit_group();
    S c[V], s[V];
    plane_sums<T, S, STENCIL>(slot(it), w, lane, c, s);
    if (zz > z0) {  // plane zz-1 now has both z-neighbours
      S y[V];
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const S nsum = (STENCIL == 27) ? (s_prev[j] + s_cur[j]) + s[j] : (c_prev[j] + s_cur[j]) + c[j];
        y[j] = S(28) * c_cur[j] - nsum;
      }
      emit(zz - 1, c_cur, y);
    }
#pragma unroll
    for (int j = 0; j < V; ++j) {
      c_prev[j] = c_cur[j];
      c_cur[j] = c[j];
      s_prev[j] = s_cur[j];
      s_cur[j] = s[j];
    }
  }
}

}  // namespace stage
}  // namespace hpccg
