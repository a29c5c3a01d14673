// The z-marching stencil tile step shared by the stencil kernels
// (stencil.cu: K1, K2, K3) and the whole-solve kernel (wholesolve.cu).
//
// A is the implicit generated-problem operator: A u = 28 u - S(u), where S
// is the boundary-clipped 27-point (or 7-point) neighbour sum including the
// point itself. Vectors are the flat row-major (nz, ny, nx) layout of the
// JAX package (currow = iz*nx*ny + iy*nx + ix), with no padding.
//
// A block of TILE_X x TILE_Y threads owns one xy tile and marches in z over
// the planes [z0, z1). Each input plane is loaded once into shared memory
// with a one-cell apron, and its separable xy-sum sum3_y(sum3_x(u))
// (27-point) or its in-plane 5-point sum (7-point) stays in registers for
// the next two planes, as stencil_v2.py:168-175 does with slab planes: each
// plane of u is read from device memory about once (plus the apron and the
// two halo planes per chunk, which L2 serves).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace hpccg {

constexpr int TILE_X = 32;  // tile width in x (one warp)
constexpr int TILE_Y = 8;   // tile height in y
constexpr int TILE_NT = TILE_X * TILE_Y;

// March one tile over the output planes [z0, z1).
//   load(zz, gy, gx) -> S: the input point at plane zz (z0-1 <= zz <= z1),
//     row gy, column gx (either may lie one cell outside the grid); the
//     caller returns zero outside the domain (or an external halo plane).
//   emit(z, c, y): called by every thread once per output plane z, with the
//     thread's own input point c = u[z, iy, ix] and y = (A u)[z, iy, ix];
//     the caller drops threads whose (ix, iy) lies outside the grid.
// `tile` is (TILE_Y + 2) x (TILE_X + 2) shared memory. Every thread of the
// block must call this (it synchronises the block).
template <typename S, int STENCIL, typename Load, typename Emit>
__device__ __forceinline__ void march_tile(S (*tile)[TILE_X + 2], int bx0, int by0, int z0, int z1,
                                           Load&& load, Emit&& emit) {
  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * TILE_X + tx;
  // c_*: the point itself on planes z-1, z; s_*: its in-plane sum there
  S c_prev = S(0), c_cur = S(0), s_prev = S(0), s_cur = S(0);
  for (int zz = z0 - 1; zz <= z1; ++zz) {
    __syncthreads();  // the previous plane's reads are done
    for (int i = tid; i < (TILE_Y + 2) * (TILE_X + 2); i += TILE_NT) {
      const int ly = i / (TILE_X + 2), lx = i % (TILE_X + 2);
      tile[ly][lx] = load(zz, by0 + ly - 1, bx0 + lx - 1);
    }
    __syncthreads();
    const S c = tile[ty + 1][tx + 1];
    S s;
    if (STENCIL == 27) {
      // sum3_y(sum3_x(u)), associated as the JAX package's _axis_sum3
      const S xm = (tile[ty][tx] + tile[ty][tx + 1]) + tile[ty][tx + 2];
      const S x0 = (tile[ty + 1][tx] + c) + tile[ty + 1][tx + 2];
      const S xp = (tile[ty + 2][tx] + tile[ty + 2][tx + 1]) + tile[ty + 2][tx + 2];
      s = (xm + x0) + xp;
    } else {
      s = ((tile[ty + 1][tx] + c) + tile[ty + 1][tx + 2]) + (tile[ty][tx + 1] + tile[ty + 2][tx + 1]);
    }
    if (zz > z0) {  // plane zz-1 now has both z-neighbours
      const S nsum = (STENCIL == 27) ? (s_prev + s_cur) + s : (c_prev + s_cur) + c;
      emit(zz - 1, c_cur, S(28) * c_cur - nsum);
    }
    c_prev = c_cur;
    c_cur = c;
    s_prev = s_cur;
    s_cur = s;
  }
}

}  // namespace hpccg
