// Stencil SpMV kernels for Hopper (sm_90a): K1, K2 and K3 of the port, and
// K7 (K2's float64 instance).
//
// Replaces the TPU kernels
//   hpccg_tpu/ops/pallas/stencil_v2.py:_kernel      (K1: y = A u)
//   hpccg_tpu/ops/pallas/stencil_v2.py:_kernel_pap  (K2: y = A u and u . y)
//   hpccg_tpu/ops/pallas/fused_cg.py:_k1            (K3: p' = r + beta p,
//                                                    Ap' = A p', p' . Ap')
// and computes the product of stencil_kernel.py:_kernel (K8) as well.
//
// A is the implicit generated-problem operator: A u = 28 u - S(u), where S
// is the boundary-clipped 27-point (or 7-point) neighbour sum including the
// point itself. Vectors are the flat row-major (nz, ny, nx) layout of the
// JAX package (currow = iz*nx*ny + iy*nx + ix), with no padding.
//
// What bounds it on the card: memory bandwidth. Per point K3 does ~35 flops
// on 16 bytes (f32: r and p read, p' and Ap' written), about 2 flops a byte
// against the H100's ~20 (f32 without tensor cores). Tensor cores have no
// role in a 1-flop-per-byte stencil: there is no product to feed them. At
// 256^3 f32 K3 must move 268 MB, 80 us at 3.35 TB/s. Its first form (one
// plane in flight per block, a scalar load per element and two barriers per
// plane) streamed 1.27 TB/s: each thread had 4 bytes of each array in
// flight, so it waited on latency, not bandwidth.
//
// What the design does about it:
//   - A thread owns V consecutive x points, one 16-byte access of each
//     array (V = 4 in f32, 8 in bf16, 2 in f64); a warp spans 32 V columns
//     and a block is TY warps, one output row each, so a tile is 32 V x TY.
//   - A block marches in z over a chunk of zc planes. Each input plane of
//     the tile, with a one-row apron in y and a 16-byte apron vector on
//     each side in x, is staged in shared memory by cp.async into a ring of
//     planes (NSTAGE for K1/K2, one fewer for K3, which stages two inputs):
//     the next planes are in flight while plane zz is summed. One block
//     barrier per plane.
//   - The xy-sum of a plane (sum3_y(sum3_x(u)), or the 5-point sum) stays in
//     registers for the next two planes, so each plane is read from device
//     memory about once; the apron rows and the two halo planes of a chunk
//     are mostly served by L2. The x neighbours come from the neighbouring
//     lanes by shuffles.
//   - zc is the largest of ZC_MAX, ZC_MAX/2, ... that still gives the grid
//     MIN_BLOCKS blocks, so a small grid (100^3) still fills the 132 SMs.
//   - With FUSE_P each thread forms p' = r + beta p, rounded to T, over the
//     staged elements it copied itself (apron included) before the plane's
//     barrier, in place of r: p' is formed once per staged element, and Ap'
//     is A of the p' that is stored. beta is read through a device pointer.
//   - With PAP each block writes its partial of u . y to partials[block]:
//     a warp sums by shuffles, the warps' sums are added in a fixed order,
//     and the finalize kernel (fused_cg.cu) sums the partials in a fixed
//     order. The TPU grid carried the dot in SMEM across its sequential
//     steps (stencil_v2.py:290-294, fused_cg.py:107-111); blocks on Hopper
//     run in no order, and float atomics would make the sum differ run to
//     run.
//   - Alignment: a vector may be a view at any element offset. The widest
//     access of 16, 8, 4 (or 2, bf16) bytes that divides every pointer and
//     the row pitch nx * sizeof(T) is taken for the whole launch: 16-byte
//     cp.async and stores where everything is aligned, narrower cp.async
//     (or, for 2 bytes, plain loads) otherwise, in the same kernel.
//   - Boundary clipping comes from the indices: chunks outside the grid are
//     zero-filled. halo_below / halo_above ((ny, nx) planes, null = domain
//     boundary) keep K1's external-halo semantics (stencil_v2.py:161-166)
//     for z-shards.
//   - Offsets into the vectors are 64-bit: nz*ny*nx passes 2^31 at 1291^3.
//   - `active` (device int, may be null): when it is 0 the kernel returns
//     without writing, so launches after the CG exit are no-ops.
//   - bf16 storage (T = __nv_bfloat16, S = float, storage.cuh), the
//     instance that stencil_v2.py:137-142 and fused_cg.py run on bf16 refs:
//     loads upcast, the 27-point sum, p' = r + beta p and the partials run in
//     f32, stores round to bf16; beta and the partials are f32. The partial
//     sums p' . Ap' over the stored values: K4's r -= alpha Ap' reads that
//     stored Ap', so alpha pairs the p.Ap that the update sees. The halo
//     planes are T as well (the distributed path).
//   - p' = r + beta p is rounded one operation at a time (no FMA
//     contraction), as the plain torch version computes it: p' matches it
//     bit for bit in every dtype. The 27-point sum keeps the JAX package's
//     association ((left + centre) + right per row, then rows, then
//     planes), as the whole-solve kernel's march_tile (stencil_tile.cuh).
//
// TY, ZC_MAX, NSTAGE and MIN_BLOCKS are compile-time constants, chosen by
// measurement on an H100 (scripts/stencil_tile_sweep.py, PERF.md); each can
// be set with a -D define of its HPCCG_STENCIL_* name.

#include <cuda_runtime.h>
#include <stdint.h>

#include "reduce.cuh"
#include "storage.cuh"

#ifndef HPCCG_STENCIL_TY
#define HPCCG_STENCIL_TY 8
#endif
#ifndef HPCCG_STENCIL_ZC
#define HPCCG_STENCIL_ZC 32
#endif
#ifndef HPCCG_STENCIL_NSTAGE
#define HPCCG_STENCIL_NSTAGE 3
#endif
#ifndef HPCCG_STENCIL_MIN_BLOCKS
#define HPCCG_STENCIL_MIN_BLOCKS 264
#endif

namespace {

using hpccg::add_rn;
using hpccg::from_s;
using hpccg::mul_rn;
using hpccg::to_s;

constexpr int TY = HPCCG_STENCIL_TY;          // warps per block, one output row each
constexpr int NT = 32 * TY;                   // threads per block
constexpr int ZC_MAX = HPCCG_STENCIL_ZC;      // z-planes per block, at most
constexpr int NSTAGE = HPCCG_STENCIL_NSTAGE;  // staged planes in the ring of one input
constexpr int MIN_BLOCKS = HPCCG_STENCIL_MIN_BLOCKS;
constexpr int ROWS = TY + 2;  // staged rows: the tile's and its y-apron
constexpr int ROW_BYTES = 34 * 16;  // staged row: 32 lanes' vectors and an apron vector each side
static_assert(NT <= 1024 && NSTAGE >= 2 && ZC_MAX >= 1, "stencil tile constants");

// Ring slots for NA staged inputs: K3's ring (r and p) is one slot shorter
// than K1/K2's, so that about the same bytes are in flight per block (the
// faster of the two in f32 on an H100; PERF.md).
__host__ __device__ constexpr int ring_slots(int na) { return na == 1 ? NSTAGE : (NSTAGE > 2 ? NSTAGE - 1 : 2); }

template <typename T>
struct Geo {
  static constexpr int V = 16 / (int)sizeof(T);  // points per thread
  static constexpr int TX = 32 * V;              // tile width
  static constexpr int ROW = ROW_BYTES / (int)sizeof(T);
  static constexpr int PLANE = ROWS * ROW;  // elements of one staged plane
};

template <typename T, typename S>
struct Args {
  const T* u;  // K1/K2: u; K3: r
  const T* v;  // K3: p
  const S* beta;
  const T* hb_u;  // plane -1 of u (r), null at the domain boundary
  const T* ha_u;  // plane nz
  const T* hb_v;
  const T* ha_v;
  T* out_p;
  T* out_y;
  S* partials;
  const int* active;
  int nx, ny, nz;
  int zc;      // z-planes per block
  int access;  // bytes per access: 16, 8, 4 or 2
};

// ------------------------------------------------------------ async copies

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// One staged chunk of `bytes` bytes: cp.async for 16, 8 and 4 bytes, a
// plain load and store for 2 (cp.async copies at least 4).
__device__ __forceinline__ void copy_chunk(void* dst, const void* src, int bytes) {
  if (bytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src) : "memory");
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
__device__ __forceinline__ const T* source(const T* base, const T* below, const T* above, int zz,
                                           int gy, int gx, int nx, int ny, int nz) {
  if (gy < 0 || gy >= ny || gx < 0 || gx >= nx) return nullptr;
  const T* plane = zz < 0 ? below : (zz >= nz ? above : base + (int64_t)zz * ny * nx);
  return plane == nullptr ? nullptr : plane + (int64_t)gy * nx + gx;
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

// Start the copies of plane zz of the NA inputs into `slot` (NA planes of
// Geo<T>::PLANE elements). Each thread takes chunks tid, tid + NT, ...;
// the same chunks in every input, so that it can form p' over them.
template <typename T, typename S, int NA>
__device__ __forceinline__ void stage_plane(T* slot, const Args<T, S>& a, int zz, int bx0, int by0) {
  constexpr int V = Geo<T>::V;
  const int nchunks = ROWS * ROW_BYTES / a.access;
  for (int c = threadIdx.x; c < nchunks; c += NT) {
    int ly, lx;
    chunk_pos(c, a.access, (int)sizeof(T), ly, lx);
    const int gy = by0 + ly - 1, gx = bx0 - V + lx;
    const T* su = source(a.u, a.hb_u, a.ha_u, zz, gy, gx, a.nx, a.ny, a.nz);
    T* du = slot + ly * Geo<T>::ROW + lx;
    if (su != nullptr) {
      copy_chunk(du, su, a.access);
    } else {
      zero_chunk(du, a.access);
    }
    if (NA == 2) {
      const T* sv = source(a.v, a.hb_v, a.ha_v, zz, gy, gx, a.nx, a.ny, a.nz);
      T* dv = du + Geo<T>::PLANE;
      if (sv != nullptr) {
        copy_chunk(dv, sv, a.access);
      } else {
        zero_chunk(dv, a.access);
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
__device__ __forceinline__ void form_p(T* slot, const Args<T, S>& a, S beta, int zz, int bx0, int by0) {
  constexpr int V = Geo<T>::V;
  const int nchunks = ROWS * ROW_BYTES / a.access;
  for (int c = threadIdx.x; c < nchunks; c += NT) {
    int ly, lx;
    chunk_pos(c, a.access, (int)sizeof(T), ly, lx);
    const int gy = by0 + ly - 1, gx = bx0 - V + lx;
    if (source(a.u, a.hb_u, a.ha_u, zz, gy, gx, a.nx, a.ny, a.nz) == nullptr) continue;
    T* r = slot + ly * Geo<T>::ROW + lx;
    const T* p = r + Geo<T>::PLANE;
    if (a.access == 16) {
      form_p_chunk<T, S, uint4>(r, p, beta);
    } else if (a.access == 8) {
      form_p_chunk<T, S, uint2>(r, p, beta);
    } else if (a.access == 4) {
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

template <typename T, typename S, int STENCIL, bool FUSE_P, bool PAP>
__global__ void __launch_bounds__(NT) stencil_kernel(const __grid_constant__ Args<T, S> a) {
  constexpr int V = Geo<T>::V, NA = FUSE_P ? 2 : 1, RING = ring_slots(NA);
  if (a.active != nullptr && *a.active == 0) return;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);  // RING slots of NA planes
  __shared__ S red[TY];

  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int bx0 = blockIdx.x * Geo<T>::TX, by0 = blockIdx.y * TY;
  const int ix0 = bx0 + lane * V, iy = by0 + w;
  const int z0 = blockIdx.z * a.zc, z1 = min(z0 + a.zc, a.nz);
  const int64_t plane = (int64_t)a.nx * a.ny;
  const bool row_inside = iy < a.ny;
  const bool wide = a.access == 16 && ix0 + V <= a.nx;  // one 16-byte store
  const S beta = FUSE_P ? *a.beta : S(0);
  auto slot = [&](int i) { return ring + (i % RING) * (NA * Geo<T>::PLANE); };

  // planes z0-1 .. z1: the first RING-1 in flight before the march
#pragma unroll
  for (int i = 0; i < RING - 1; ++i) {
    if (z0 - 1 + i <= z1) stage_plane<T, S, NA>(slot(i), a, z0 - 1 + i, bx0, by0);
    commit_group();
  }
  // c: the thread's points on planes z-1, z; s: their in-plane sums there
  S c_prev[V], c_cur[V], s_prev[V], s_cur[V];
#pragma unroll
  for (int j = 0; j < V; ++j) c_prev[j] = c_cur[j] = s_prev[j] = s_cur[j] = S(0);
  S acc = S(0);
  for (int zz = z0 - 1, it = 0; zz <= z1; ++zz, ++it) {
    wait_group<RING - 2>();  // this thread's copies of plane zz have landed
    if (FUSE_P) form_p<T, S>(slot(it), a, beta, zz, bx0, by0);
    __syncthreads();  // plane zz is staged for all; plane zz-1's reads are done
    if (zz + RING - 1 <= z1) stage_plane<T, S, NA>(slot(it + RING - 1), a, zz + RING - 1, bx0, by0);
    commit_group();
    S c[V], s[V];
    plane_sums<T, S, STENCIL>(slot(it), w, lane, c, s);
    if (zz > z0 && row_inside) {  // plane zz-1 now has both z-neighbours
      alignas(16) T yt[V];
      alignas(16) T pt[V];
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const S nsum = (STENCIL == 27) ? (s_prev[j] + s_cur[j]) + s[j] : (c_prev[j] + s_cur[j]) + c[j];
        yt[j] = from_s<T>(S(28) * c_cur[j] - nsum);
        pt[j] = from_s<T>(c_cur[j]);
        if (PAP && ix0 + j < a.nx) acc += c_cur[j] * to_s(yt[j]);  // over the stored Ap
      }
      const int64_t o = (int64_t)(zz - 1) * plane + (int64_t)iy * a.nx + ix0;
      if (wide) {
        *reinterpret_cast<uint4*>(a.out_y + o) = *reinterpret_cast<const uint4*>(yt);
        if (FUSE_P) *reinterpret_cast<uint4*>(a.out_p + o) = *reinterpret_cast<const uint4*>(pt);
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j) {
          if (ix0 + j < a.nx) {
            a.out_y[o + j] = yt[j];
            if (FUSE_P) a.out_p[o + j] = pt[j];
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < V; ++j) {
      c_prev[j] = c_cur[j];
      c_cur[j] = c[j];
      s_prev[j] = s_cur[j];
      s_cur[j] = s[j];
    }
  }
  if (PAP) {
    acc = hpccg::warp_sum(acc);
    if (lane == 0) red[w] = acc;
    __syncthreads();
    if (threadIdx.x == 0) {
      S total = red[0];
#pragma unroll
      for (int i = 1; i < TY; ++i) total += red[i];
      a.partials[((int64_t)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x] = total;
    }
  }
}

// The launch geometry of an nx*ny*nz grid of esize-byte elements: the grid
// and the z-planes per block.
dim3 stencil_grid(int nx, int ny, int nz, int esize, int* zc_out) {
  const int tx = 32 * (16 / esize);
  const long long gx = (nx + tx - 1) / tx, gy = (ny + TY - 1) / TY;
  int zc = ZC_MAX;
  while (zc > 1 && gx * gy * ((nz + zc - 1) / zc) < MIN_BLOCKS) zc /= 2;
  if (zc_out != nullptr) *zc_out = zc;
  return dim3((unsigned)gx, (unsigned)gy, (unsigned)((nz + zc - 1) / zc));
}

// The widest access (16, 8, 4 or 2 bytes) that divides the row pitch and
// every pointer.
int access_bytes(int nx, int esize, const void* const* ptrs, int n) {
  uintptr_t m = (uintptr_t)16 | ((uintptr_t)nx * (uintptr_t)esize);
  for (int i = 0; i < n; ++i) m |= (uintptr_t)ptrs[i];
  return (int)(m & (~m + 1));
}

template <typename T, typename S, int STENCIL, bool FUSE_P, bool PAP>
int launch_one(const Args<T, S>& a, dim3 grid, cudaStream_t stream) {
  constexpr int NA = FUSE_P ? 2 : 1;
  const int smem = ring_slots(NA) * NA * Geo<T>::PLANE * (int)sizeof(T);
  auto kern = stencil_kernel<T, S, STENCIL, FUSE_P, PAP>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<grid, NT, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, typename S, int STENCIL>
int launch_variant(const Args<T, S>& a, dim3 grid, int fuse_p, int pap, cudaStream_t stream) {
  if (fuse_p) return launch_one<T, S, STENCIL, true, true>(a, grid, stream);
  if (pap) return launch_one<T, S, STENCIL, false, true>(a, grid, stream);
  return launch_one<T, S, STENCIL, false, false>(a, grid, stream);
}

template <typename T, typename S>
int launch_stencil(const T* u, const T* v, const S* beta, const T* hb_u, const T* ha_u,
                   const T* hb_v, const T* ha_v, T* out_p, T* out_y, S* partials,
                   const int* active, int nx, int ny, int nz, int stencil, int fuse_p, int pap,
                   void* stream) {
  // FUSE_P always carries the p'.Ap' partial (K3); other shapes are refused
  if ((stencil != 27 && stencil != 7) || (fuse_p && !pap) || nx < 1 || ny < 1 || nz < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const void* ptrs[] = {u, v, hb_u, ha_u, hb_v, ha_v, out_p, out_y};
  Args<T, S> a{u, v, beta, hb_u, ha_u, hb_v, ha_v, out_p, out_y, partials, active, nx, ny, nz, 0,
               access_bytes(nx, (int)sizeof(T), ptrs, 8)};
  if (a.access < 4 && sizeof(T) >= 4) return (int)cudaErrorMisalignedAddress;
  const dim3 grid = stencil_grid(nx, ny, nz, (int)sizeof(T), &a.zc);
  cudaStream_t s = (cudaStream_t)stream;
  return stencil == 27 ? launch_variant<T, S, 27>(a, grid, fuse_p, pap, s)
                       : launch_variant<T, S, 7>(a, grid, fuse_p, pap, s);
}

}  // namespace

extern "C" {

// Number of blocks (= partials written by K2/K3) for an nx*ny*nz grid of
// esize-byte elements (4: float32, 8: float64, 2: bfloat16).
int hpccg_stencil_num_blocks(int nx, int ny, int nz, int esize) {
  const dim3 g = stencil_grid(nx, ny, nz, esize, nullptr);
  return (int)(g.x * g.y * g.z);
}

// The tile and chunk of that grid: out = {tile width, tile height, z-planes
// per block, blocks}.
int hpccg_stencil_geometry(int nx, int ny, int nz, int esize, int* out) {
  int zc;
  const dim3 g = stencil_grid(nx, ny, nz, esize, &zc);
  out[0] = 32 * (16 / esize);
  out[1] = TY;
  out[2] = zc;
  out[3] = (int)(g.x * g.y * g.z);
  return 0;
}

int hpccg_stencil_f32(const float* u, const float* v, const float* beta, const float* hb_u,
                      const float* ha_u, const float* hb_v, const float* ha_v, float* out_p,
                      float* out_y, float* partials, const int* active, int nx, int ny, int nz,
                      int stencil, int fuse_p, int pap, void* stream) {
  return launch_stencil<float, float>(u, v, beta, hb_u, ha_u, hb_v, ha_v, out_p, out_y, partials,
                                      active, nx, ny, nz, stencil, fuse_p, pap, stream);
}

int hpccg_stencil_f64(const double* u, const double* v, const double* beta, const double* hb_u,
                      const double* ha_u, const double* hb_v, const double* ha_v, double* out_p,
                      double* out_y, double* partials, const int* active, int nx, int ny, int nz,
                      int stencil, int fuse_p, int pap, void* stream) {
  return launch_stencil<double, double>(u, v, beta, hb_u, ha_u, hb_v, ha_v, out_p, out_y,
                                        partials, active, nx, ny, nz, stencil, fuse_p, pap, stream);
}

// bf16 vectors and halo planes; beta and the partials float32.
int hpccg_stencil_bf16(const __nv_bfloat16* u, const __nv_bfloat16* v, const float* beta,
                       const __nv_bfloat16* hb_u, const __nv_bfloat16* ha_u,
                       const __nv_bfloat16* hb_v, const __nv_bfloat16* ha_v,
                       __nv_bfloat16* out_p, __nv_bfloat16* out_y, float* partials,
                       const int* active, int nx, int ny, int nz, int stencil, int fuse_p,
                       int pap, void* stream) {
  return launch_stencil<__nv_bfloat16, float>(u, v, beta, hb_u, ha_u, hb_v, ha_v, out_p, out_y,
                                              partials, active, nx, ny, nz, stencil, fuse_p, pap,
                                              stream);
}

}  // extern "C"
