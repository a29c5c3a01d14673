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
//     planes).
//
// The staging, the sums and the march are stencil_stage.cuh's, which the
// whole-solve kernels (wholesolve.cu, collective.cu) share. TY, ZC_MAX, NSTAGE and
// MIN_BLOCKS are compile-time constants, chosen by measurement on an H100
// (scripts/stencil_tile_sweep.py, PERF.md); each can be set with a -D
// define of its HPCCG_STENCIL_* name.

#include <cuda_runtime.h>
#include <stdint.h>

#include "reduce.cuh"
#include "stencil_stage.cuh"
#include "storage.cuh"

#ifndef HPCCG_STENCIL_ZC
#define HPCCG_STENCIL_ZC 32
#endif
#ifndef HPCCG_STENCIL_MIN_BLOCKS
#define HPCCG_STENCIL_MIN_BLOCKS 264
#endif

namespace {

using hpccg::from_s;
using hpccg::to_s;
using namespace hpccg::stage;

constexpr int ZC_MAX = HPCCG_STENCIL_ZC;  // z-planes per block, at most
constexpr int MIN_BLOCKS = HPCCG_STENCIL_MIN_BLOCKS;
static_assert(ZC_MAX >= 1, "stencil tile constants");

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

template <typename T, typename S, int STENCIL, bool FUSE_P, bool PAP>
__global__ void __launch_bounds__(NT) stencil_kernel(const __grid_constant__ Args<T, S> a) {
  constexpr int V = Geo<T>::V;
  if (a.active != nullptr && *a.active == 0) return;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ S red[TY];

  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int bx0 = blockIdx.x * Geo<T>::TX, by0 = blockIdx.y * TY;
  const int ix0 = bx0 + lane * V, iy = by0 + w;
  const int z0 = blockIdx.z * a.zc, z1 = min(z0 + a.zc, a.nz);
  const int64_t plane = (int64_t)a.nx * a.ny;
  const bool row_inside = iy < a.ny;
  const bool wide = a.access == 16 && ix0 + V <= a.nx;  // one 16-byte store
  const S beta = FUSE_P ? *a.beta : S(0);
  S acc = S(0);
  march<T, S, STENCIL, FUSE_P ? 2 : 1, FUSE_P, false>(
      reinterpret_cast<T*>(smem_raw), {a.u, a.hb_u, a.ha_u}, {a.v, a.hb_v, a.ha_v}, {a.nx, a.ny, a.nz, a.access},
      beta, bx0, by0, z0, z1, [&](int z, const S(&c)[V], const S(&y)[V]) {
        if (!row_inside) return;
        alignas(16) T yt[V];
        alignas(16) T pt[V];
#pragma unroll
        for (int j = 0; j < V; ++j) {
          yt[j] = from_s<T>(y[j]);
          pt[j] = from_s<T>(c[j]);
          if (PAP && ix0 + j < a.nx) acc += c[j] * to_s(yt[j]);  // over the stored Ap
        }
        const int64_t o = (int64_t)z * plane + (int64_t)iy * a.nx + ix0;
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
      });
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

template <typename T, typename S, int STENCIL, bool FUSE_P, bool PAP>
int launch_one(const Args<T, S>& a, dim3 grid, cudaStream_t stream) {
  constexpr int NA = FUSE_P ? 2 : 1;
  const int smem = ring_bytes(NA);
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
