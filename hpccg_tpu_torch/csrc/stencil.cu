// Stencil SpMV kernels for Hopper (sm_90a): K1, K2 and K3 of the port.
//
// Replaces the TPU kernels
//   hpccg_tpu/ops/pallas/stencil_v2.py:_kernel      (K1: y = A u)
//   hpccg_tpu/ops/pallas/stencil_v2.py:_kernel_pap  (K2: y = A u and u . y)
//   hpccg_tpu/ops/pallas/fused_cg.py:_k1            (K3: p' = r + beta p,
//                                                    Ap' = A p', p' . Ap')
// and computes the product of stencil_kernel.py:_kernel (K8) as well.
//
// A and the vector layout: stencil_tile.cuh.
//
// What bounds it on the card: memory bandwidth. Per point K1 does ~30 flops
// on one read of u and one write of y (8 B in f32), far below the H100's
// flop-per-byte balance. K3 reads r and p and writes p' and Ap': about 4
// vectors per iteration, ~16 MB at 100^3 f32, ~5 us at 3.35 TB/s.
//
// What the design does about it:
//   - A block owns a 32x8 xy tile and marches in z over a chunk of ZC
//     planes (hpccg::march_tile, stencil_tile.cuh, shared with the
//     whole-solve kernel): each plane of u is read from device memory about
//     once.
//   - With FUSE_P the kernel forms p' = r + beta p as it loads, so p' never
//     makes an extra round trip; beta is read through a device pointer.
//   - With PAP each block writes its partial of u . y to partials[block]; a
//     single-block finalize kernel (fused_cg.cu) sums them in a fixed order.
//     The TPU grid carried the dot in SMEM across its sequential steps
//     (stencil_v2.py:290-294, fused_cg.py:107-111); blocks on Hopper run in
//     no order, and float atomics would make the sum differ run to run.
//   - Boundary clipping comes from the indices, not from a mask array.
//     halo_below / halo_above ((ny, nx) planes, null = domain boundary) keep
//     K1's external-halo semantics (stencil_v2.py:161-166) for z-shards.
//   - Offsets into the vectors are 64-bit: nz*ny*nx passes 2^31 at 1291^3.
//   - `active` (device int, may be null): when it is 0 the kernel returns
//     without writing, so launches after the CG exit are no-ops.
// Simple first: no TMA, clusters or warp specialisation yet.

#include "reduce.cuh"
#include "stencil_tile.cuh"

namespace {

using hpccg::TILE_NT;
using hpccg::TILE_X;
using hpccg::TILE_Y;
constexpr int ZC = 16;  // z-planes per block

// One point of the (possibly fused) input plane zz, zero outside the grid.
// Planes -1 and nz come from the halo pointers (zero when null).
template <typename T, bool FUSE_P>
__device__ __forceinline__ T load_point(const T* __restrict__ u, const T* __restrict__ v, T beta,
                                        const T* hb_u, const T* ha_u, const T* hb_v,
                                        const T* ha_v, int zz, int gy, int gx, int nx, int ny,
                                        int nz) {
  if (gx < 0 || gx >= nx || gy < 0 || gy >= ny) return T(0);
  const int64_t inplane = (int64_t)gy * nx + gx;
  const T* su;
  const T* sv;
  int64_t off;
  if (zz < 0) {
    su = hb_u;
    sv = hb_v;
    off = inplane;
  } else if (zz >= nz) {
    su = ha_u;
    sv = ha_v;
    off = inplane;
  } else {
    su = u;
    sv = v;
    off = (int64_t)zz * nx * ny + inplane;
  }
  if (su == nullptr) return T(0);
  T val = su[off];
  if (FUSE_P) val = val + beta * sv[off];
  return val;
}

template <typename T, int STENCIL, bool FUSE_P, bool PAP>
__global__ void __launch_bounds__(TILE_NT)
    stencil_kernel(const T* __restrict__ u, const T* __restrict__ v, const T* beta_ptr,
                   const T* hb_u, const T* ha_u, const T* hb_v, const T* ha_v,
                   T* __restrict__ out_p, T* __restrict__ out_y, T* __restrict__ partials,
                   const int* active, int nx, int ny, int nz) {
  if (active != nullptr && *active == 0) return;
  __shared__ T tile[TILE_Y + 2][TILE_X + 2];
  __shared__ T red[PAP ? TILE_NT : 1];

  const int tid = threadIdx.y * TILE_X + threadIdx.x;
  const int bx0 = blockIdx.x * TILE_X, by0 = blockIdx.y * TILE_Y;
  const int ix = bx0 + threadIdx.x, iy = by0 + threadIdx.y;
  const bool inside = ix < nx && iy < ny;
  const int z0 = blockIdx.z * ZC;
  const int z1 = min(z0 + ZC, nz);
  const int64_t plane = (int64_t)nx * ny;
  const int64_t inplane = (int64_t)iy * nx + ix;
  const T beta = FUSE_P ? *beta_ptr : T(0);

  T acc = T(0);
  hpccg::march_tile<T, STENCIL>(
      tile, bx0, by0, z0, z1,
      [&](int zz, int gy, int gx) {
        return load_point<T, FUSE_P>(u, v, beta, hb_u, ha_u, hb_v, ha_v, zz, gy, gx, nx, ny, nz);
      },
      [&](int z, T c, T y) {
        if (!inside) return;
        const int64_t o = (int64_t)z * plane + inplane;
        out_y[o] = y;
        if (FUSE_P) out_p[o] = c;
        if (PAP) acc += c * y;
      });
  if (PAP) {
    const T total = hpccg::block_sum<T, TILE_NT>(acc, red, tid);
    if (tid == 0) {
      partials[((int64_t)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x] = total;
    }
  }
}

dim3 stencil_grid(int nx, int ny, int nz) {
  return dim3((nx + TILE_X - 1) / TILE_X, (ny + TILE_Y - 1) / TILE_Y, (nz + ZC - 1) / ZC);
}

template <typename T, int STENCIL>
void launch_variant(const T* u, const T* v, const T* beta, const T* hb_u, const T* ha_u,
                    const T* hb_v, const T* ha_v, T* out_p, T* out_y, T* partials,
                    const int* active, int nx, int ny, int nz, int fuse_p, int pap,
                    cudaStream_t stream) {
  const dim3 grid = stencil_grid(nx, ny, nz);
  const dim3 block(TILE_X, TILE_Y);
  if (fuse_p) {
    stencil_kernel<T, STENCIL, true, true><<<grid, block, 0, stream>>>(
        u, v, beta, hb_u, ha_u, hb_v, ha_v, out_p, out_y, partials, active, nx, ny, nz);
  } else if (pap) {
    stencil_kernel<T, STENCIL, false, true><<<grid, block, 0, stream>>>(
        u, v, beta, hb_u, ha_u, hb_v, ha_v, out_p, out_y, partials, active, nx, ny, nz);
  } else {
    stencil_kernel<T, STENCIL, false, false><<<grid, block, 0, stream>>>(
        u, v, beta, hb_u, ha_u, hb_v, ha_v, out_p, out_y, partials, active, nx, ny, nz);
  }
}

template <typename T>
int launch_stencil(const T* u, const T* v, const T* beta, const T* hb_u, const T* ha_u,
                   const T* hb_v, const T* ha_v, T* out_p, T* out_y, T* partials,
                   const int* active, int nx, int ny, int nz, int stencil, int fuse_p, int pap,
                   void* stream) {
  // FUSE_P always carries the p'.Ap' partial (K3); other shapes are refused
  if ((stencil != 27 && stencil != 7) || (fuse_p && !pap) || nx < 1 || ny < 1 || nz < 1) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  if (stencil == 27) {
    launch_variant<T, 27>(u, v, beta, hb_u, ha_u, hb_v, ha_v, out_p, out_y, partials, active,
                          nx, ny, nz, fuse_p, pap, s);
  } else {
    launch_variant<T, 7>(u, v, beta, hb_u, ha_u, hb_v, ha_v, out_p, out_y, partials, active,
                         nx, ny, nz, fuse_p, pap, s);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Number of blocks (= partials written by K2/K3) for an nx*ny*nz grid.
int hpccg_stencil_num_blocks(int nx, int ny, int nz) {
  const dim3 g = stencil_grid(nx, ny, nz);
  return (int)(g.x * g.y * g.z);
}

int hpccg_stencil_f32(const float* u, const float* v, const float* beta, const float* hb_u,
                      const float* ha_u, const float* hb_v, const float* ha_v, float* out_p,
                      float* out_y, float* partials, const int* active, int nx, int ny, int nz,
                      int stencil, int fuse_p, int pap, void* stream) {
  return launch_stencil<float>(u, v, beta, hb_u, ha_u, hb_v, ha_v, out_p, out_y, partials,
                               active, nx, ny, nz, stencil, fuse_p, pap, stream);
}

int hpccg_stencil_f64(const double* u, const double* v, const double* beta, const double* hb_u,
                      const double* ha_u, const double* hb_v, const double* ha_v, double* out_p,
                      double* out_y, double* partials, const int* active, int nx, int ny, int nz,
                      int stencil, int fuse_p, int pap, void* stream) {
  return launch_stencil<double>(u, v, beta, hb_u, ha_u, hb_v, ha_v, out_p, out_y, partials,
                                active, nx, ny, nz, stencil, fuse_p, pap, stream);
}

}  // extern "C"
