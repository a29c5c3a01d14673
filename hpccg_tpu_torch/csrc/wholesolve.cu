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
//     A: p' = r + beta p (formed as it loads), Ap' = A p', partial of p'.Ap'
//        -- grid sync -- alpha = rtrans / p'.Ap'
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
// for K5's form here and for K3+K4 (pallas_fused). This is K6's trade, made
// on the TPU to fit VMEM (streamkernel.py:9-14); here it saves bandwidth.
//
// bf16 state (T = __nv_bfloat16, S = float): vectors are stored in bf16,
// loaded with __bfloat162float, computed in f32 and stored with
// __float2bfloat16 (round to nearest even, as torch's .to(bfloat16)). The
// partials, the scalars and the trace are f32, so niters stays exact past
// 256 (megakernel.py:133-138, :339-341). The rounding points: p' is rounded
// to T as it is formed (so Ap' = A of the stored p'), Ap' is rounded when
// K5 stores it, r and x are rounded when stored; p'.Ap' uses the unrounded
// f32 A p'. The plain torch versions (ops/cuda/wholesolve.py) round at the
// same places.
//
// What bounds it on this card. At 256^3 f32 a pass over one vector is
// 67 MB: K6's 8 passes are 537 MB per iteration, ~160 us at 3.35 TB/s,
// against 671 MB and ~200 us for K3+K4; bf16 halves both. At 100^3 the
// state (5 vectors, 20 MB in f32) fits the 50 MB L2, and the two grid
// syncs per iteration, each followed by every block summing all partials,
// are the likely bound.
//
// What the design does about it:
//   - One persistent cooperative launch (cudaLaunchCooperativeKernel): the
//     grid is the number of blocks that fit on the card at once
//     (occupancy x SMs), capped by the number of work items, so every block
//     is resident and cooperative_groups' grid sync is safe. A refused
//     cooperative launch is an error; nothing falls back.
//   - At 256^3 the kernel is bound by loads in flight, not by bytes (bf16,
//     half the bytes, ran K5 only 6% faster): __launch_bounds__(256, 4)
//     holds the registers to 64 so that 4 blocks fit on each SM instead of
//     3, and a work item marches 16 z-planes (2 halo planes in 18 loaded).
//     Measured on the H100: K5 455 -> 383 us/iter at 256^3 f32, 429 -> 344
//     in bf16; 100^3 within 2% (PERF.md, Findings).
//   - The stencil is hpccg::march_tile (stencil_tile.cuh), the same tile
//     step as K1-K3: blocks grid-stride over (x-tile, y-tile, z-chunk)
//     work items, x fastest, so neighbouring blocks share halo rows in L2.
//   - p is double-buffered: phase A of one tile reads the old p in its
//     neighbours' halo while they write p'.
//   - Deterministic and uniform scalars: each block writes one partial per
//     phase (a fixed tree inside the block); after the grid sync every
//     block sums all partials in the same fixed order and advances the
//     recurrence in registers. Every block therefore holds bit-identical
//     scalars and takes the same exit decision, which it must: a block that
//     left the loop while others wait at the grid sync would hang the card.
//     No float atomics, so two solves are bit-identical. The partials are
//     read with __ldcg (L2, never a stale L1 line).
//   - Block 0 writes trace[k] as it goes and the final scalar state (sc,
//     ic: the layout of cg_scalars.cuh) at the end, so the host builds the
//     result as for the per-iteration backends.
//   - Offsets into the vectors are 64-bit.
// Simple first: no TMA, L2 persistence windows or clusters yet.

#include <cooperative_groups.h>
#include <cuda_bf16.h>

#include "cg_scalars.cuh"
#include "reduce.cuh"
#include "stencil_tile.cuh"

namespace {

namespace coop = cooperative_groups;
using hpccg::TILE_NT;
using hpccg::TILE_X;
using hpccg::TILE_Y;
constexpr int WS_ZC = 16;         // z-planes per work item
constexpr int WS_MIN_BLOCKS = 4;  // resident blocks per SM: caps registers at 64

__device__ __forceinline__ float to_s(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_s(float v) { return v; }
__device__ __forceinline__ double to_s(double v) { return v; }

template <typename T, typename S>
__device__ __forceinline__ T from_s(S v) {
  return T(v);
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_s<__nv_bfloat16, float>(float v) {
  return __float2bfloat16(v);
}

template <typename T, typename S>
struct Params {
  const T* b;
  const T* x0;
  T* x;
  T* r;
  T* p0;
  T* p1;
  T* ap;     // K5 only (null for K6)
  S* parts;  // 2 * gridDim.x: the p.Ap partials, then the r.r partials
  S* sc;
  int* ic;
  S* trace;
  int nx, ny, nz;
};

__host__ __device__ __forceinline__ int ceil_div(int a, int b) { return (a + b - 1) / b; }

long long work_items(int nx, int ny, int nz) {
  return (long long)ceil_div(nx, TILE_X) * ceil_div(ny, TILE_Y) * ceil_div(nz, WS_ZC);
}

// Sum of one value per block over the grid: the block's total goes to
// parts[blockIdx.x]; after the grid sync every block sums all of them in
// the same order, so every thread of every block gets the same bits.
template <typename S>
__device__ __forceinline__ S grid_total(coop::grid_group& grid, S v, S* parts, S* red, int tid) {
  const S mine = hpccg::block_sum<S, TILE_NT>(v, red, tid);
  if (tid == 0) parts[blockIdx.x] = mine;
  grid.sync();
  S acc = S(0);
  for (int i = tid; i < (int)gridDim.x; i += TILE_NT) acc += __ldcg(parts + i);
  const S total = hpccg::block_sum<S, TILE_NT>(acc, red, tid);
  __syncthreads();  // every thread has read red[0] before red is reused
  return total;
}

template <typename T, typename S, int STENCIL, bool RECOMPUTE_AP>
__global__ void __launch_bounds__(TILE_NT, WS_MIN_BLOCKS) wholesolve_kernel(const Params<T, S> P) {
  coop::grid_group grid = coop::this_grid();
  __shared__ S tile[TILE_Y + 2][TILE_X + 2];
  __shared__ S red[TILE_NT];

  const int nx = P.nx, ny = P.ny, nz = P.nz;
  const int tid = threadIdx.y * TILE_X + threadIdx.x;
  const int tiles_x = ceil_div(nx, TILE_X), tiles_y = ceil_div(ny, TILE_Y);
  const int items = tiles_x * tiles_y * ceil_div(nz, WS_ZC);
  const int64_t plane = (int64_t)nx * ny;
  const int64_t n = plane * nz;
  const bool leader = blockIdx.x == 0 && tid == 0;
  S* part_pap = P.parts;
  S* part_rr = P.parts + gridDim.x;

  // Run body(bx0, by0, z0, z1, inside, inplane) for each of this block's
  // work items, in a fixed order.
  auto for_items = [&](auto&& body) {
    for (int it = blockIdx.x; it < items; it += gridDim.x) {
      const int cz = it / (tiles_x * tiles_y), rem = it % (tiles_x * tiles_y);
      const int bx0 = (rem % tiles_x) * TILE_X, by0 = (rem / tiles_x) * TILE_Y;
      const int ix = bx0 + threadIdx.x, iy = by0 + threadIdx.y;
      const int z0 = cz * WS_ZC;
      body(bx0, by0, z0, min(z0 + WS_ZC, nz), ix < nx && iy < ny, (int64_t)iy * nx + ix);
    }
  };
  // Offset of (zz, gy, gx), or -1 outside the domain (the zero boundary).
  auto offset = [&](int zz, int gy, int gx) -> int64_t {
    if (gx < 0 || gx >= nx || gy < 0 || gy >= ny || zz < 0 || zz >= nz) return -1;
    return (int64_t)zz * plane + (int64_t)gy * nx + gx;
  };

  // ---- init: x = x0; p = x0; r = b - A x0; r.r ----
  S acc = S(0);
  for_items([&](int bx0, int by0, int z0, int z1, bool inside, int64_t inplane) {
    hpccg::march_tile<S, STENCIL>(
        tile, bx0, by0, z0, z1,
        [&](int zz, int gy, int gx) {
          const int64_t o = offset(zz, gy, gx);
          return o < 0 ? S(0) : to_s(P.x0[o]);
        },
        [&](int z, S, S y) {
          if (!inside) return;
          const int64_t o = (int64_t)z * plane + inplane;
          const T xv = P.x0[o];
          P.x[o] = xv;
          P.p0[o] = xv;
          const T rv = from_s<T, S>(to_s(P.b[o]) - y);
          P.r[o] = rv;
          const S rs = to_s(rv);
          acc += rs * rs;
        });
  });
  S rt_cur = grid_total(grid, acc, part_rr, red, tid);
  S rt_prev = rt_cur;
  S normr = sqrt(rt_cur);
  const S tol = P.sc[hpccg::SC_TOL];
  const int max_iter = P.ic[hpccg::IC_MAX_ITER];
  int k = 1;
  if (leader) P.trace[0] = normr;
  bool go = k < max_iter && normr > tol;
  S beta = S(0);  // k == 1: p = r
  if (go && leader) P.trace[k] = normr;

  T* p_old = P.p0;
  T* p_new = P.p1;
  while (go) {
    // ---- phase A: p' = r + beta p, Ap' = A p', partial of p'.Ap' ----
    acc = S(0);
    for_items([&](int bx0, int by0, int z0, int z1, bool inside, int64_t inplane) {
      hpccg::march_tile<S, STENCIL>(
          tile, bx0, by0, z0, z1,
          [&](int zz, int gy, int gx) {
            const int64_t o = offset(zz, gy, gx);
            return o < 0 ? S(0) : to_s(from_s<T, S>(to_s(P.r[o]) + beta * to_s(p_old[o])));
          },
          [&](int z, S c, S y) {
            if (!inside) return;
            const int64_t o = (int64_t)z * plane + inplane;
            p_new[o] = from_s<T, S>(c);
            if (!RECOMPUTE_AP) P.ap[o] = from_s<T, S>(y);
            acc += c * y;
          });
    });
    const S alpha = rt_cur / grid_total(grid, acc, part_pap, red, tid);

    // ---- phase B: x += alpha p', r -= alpha Ap', partial of the new r.r ----
    acc = S(0);
    if (RECOMPUTE_AP) {
      for_items([&](int bx0, int by0, int z0, int z1, bool inside, int64_t inplane) {
        hpccg::march_tile<S, STENCIL>(
            tile, bx0, by0, z0, z1,
            [&](int zz, int gy, int gx) {
              const int64_t o = offset(zz, gy, gx);
              return o < 0 ? S(0) : to_s(p_new[o]);
            },
            [&](int z, S c, S y) {
              if (!inside) return;
              const int64_t o = (int64_t)z * plane + inplane;
              const T rv = from_s<T, S>(to_s(P.r[o]) - alpha * y);
              P.r[o] = rv;
              P.x[o] = from_s<T, S>(to_s(P.x[o]) + alpha * c);
              const S rs = to_s(rv);
              acc += rs * rs;
            });
      });
    } else {
      const int64_t stride = (int64_t)gridDim.x * TILE_NT;
      for (int64_t i = (int64_t)blockIdx.x * TILE_NT + tid; i < n; i += stride) {
        const T rv = from_s<T, S>(to_s(P.r[i]) - alpha * to_s(P.ap[i]));
        P.r[i] = rv;
        P.x[i] = from_s<T, S>(to_s(P.x[i]) + alpha * to_s(p_new[i]));
        const S rs = to_s(rv);
        acc += rs * rs;
      }
    }
    // ---- the end of body k: the top of body k+1 ----
    rt_prev = rt_cur;
    rt_cur = grid_total(grid, acc, part_rr, red, tid);
    ++k;
    go = k < max_iter && normr > tol;
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
    P.sc[hpccg::SC_RT_CUR] = rt_cur;
    P.sc[hpccg::SC_RT_PREV] = rt_prev;
    P.sc[hpccg::SC_ALPHA] = S(0);
    P.sc[hpccg::SC_BETA] = S(0);
    P.sc[hpccg::SC_NORMR] = normr;
    P.ic[hpccg::IC_K] = k;
    P.ic[hpccg::IC_ACTIVE] = 0;
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

// The cooperative grid for an nx*ny*nz solve: every block resident at once
// (occupancy x SMs), capped by the work items. Returns a CUDA error code.
template <typename T, typename S>
int grid_blocks(int nx, int ny, int nz, int stencil, int recompute_ap, int* blocks) {
  if ((stencil != 27 && stencil != 7) || nx < 1 || ny < 1 || nz < 1) {
    return (int)cudaErrorInvalidValue;
  }
  int dev = 0, sms = 0, coop_ok = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop_ok, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel_for<T, S>(stencil, recompute_ap),
                                                        TILE_NT, 0);
  }
  if (err != cudaSuccess) return (int)err;
  if (!coop_ok || per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  const long long items = work_items(nx, ny, nz);
  const long long resident = (long long)per_sm * sms;
  *blocks = (int)(items < resident ? items : resident);
  return (int)cudaSuccess;
}

template <typename T, typename S>
int launch_wholesolve(const T* b, const T* x0, T* x, T* r, T* p0, T* p1, T* ap, S* parts,
                      int nparts, S* sc, int* ic, S* trace, int nx, int ny, int nz, int stencil,
                      int recompute_ap, void* stream) {
  int blocks = 0;
  const int err = grid_blocks<T, S>(nx, ny, nz, stencil, recompute_ap, &blocks);
  if (err != (int)cudaSuccess) return err;
  if (nparts < 2 * blocks || (!recompute_ap && ap == nullptr)) return (int)cudaErrorInvalidValue;
  Params<T, S> params{b, x0, x, r, p0, p1, ap, parts, sc, ic, trace, nx, ny, nz};
  void* args[] = {&params};
  return (int)cudaLaunchCooperativeKernel(kernel_for<T, S>(stencil, recompute_ap), dim3(blocks),
                                          dim3(TILE_X, TILE_Y), args, 0, (cudaStream_t)stream);
}

}  // namespace

extern "C" {

// Blocks of the cooperative grid for an nx*ny*nz solve (each writes one
// partial per phase: the wrapper allocates 2 * blocks), or minus a CUDA
// error code. dtype: 0 float32, 1 float64, 2 bfloat16.
int hpccg_wholesolve_num_blocks(int nx, int ny, int nz, int dtype, int stencil, int recompute_ap) {
  int blocks = 0;
  int err;
  if (dtype == 0) {
    err = grid_blocks<float, float>(nx, ny, nz, stencil, recompute_ap, &blocks);
  } else if (dtype == 1) {
    err = grid_blocks<double, double>(nx, ny, nz, stencil, recompute_ap, &blocks);
  } else if (dtype == 2) {
    err = grid_blocks<__nv_bfloat16, float>(nx, ny, nz, stencil, recompute_ap, &blocks);
  } else {
    err = (int)cudaErrorInvalidValue;
  }
  return err == (int)cudaSuccess ? blocks : -err;
}

// Work items of an nx*ny*nz solve: (x-tile, y-tile, z-chunk) triples, which
// the blocks of the grid take in turns (an int, as the kernel counts them).
int hpccg_wholesolve_work_items(int nx, int ny, int nz) { return (int)work_items(nx, ny, nz); }

int hpccg_wholesolve_f32(const float* b, const float* x0, float* x, float* r, float* p0, float* p1,
                         float* ap, float* parts, int nparts, float* sc, int* ic, float* trace,
                         int nx, int ny, int nz, int stencil, int recompute_ap, void* stream) {
  return launch_wholesolve<float, float>(b, x0, x, r, p0, p1, ap, parts, nparts, sc, ic, trace, nx,
                                         ny, nz, stencil, recompute_ap, stream);
}

int hpccg_wholesolve_f64(const double* b, const double* x0, double* x, double* r, double* p0,
                         double* p1, double* ap, double* parts, int nparts, double* sc, int* ic,
                         double* trace, int nx, int ny, int nz, int stencil, int recompute_ap,
                         void* stream) {
  return launch_wholesolve<double, double>(b, x0, x, r, p0, p1, ap, parts, nparts, sc, ic, trace,
                                           nx, ny, nz, stencil, recompute_ap, stream);
}

int hpccg_wholesolve_bf16(const __nv_bfloat16* b, const __nv_bfloat16* x0, __nv_bfloat16* x,
                          __nv_bfloat16* r, __nv_bfloat16* p0, __nv_bfloat16* p1,
                          __nv_bfloat16* ap, float* parts, int nparts, float* sc, int* ic,
                          float* trace, int nx, int ny, int nz, int stencil, int recompute_ap,
                          void* stream) {
  return launch_wholesolve<__nv_bfloat16, float>(b, x0, x, r, p0, p1, ap, parts, nparts, sc, ic,
                                                 trace, nx, ny, nz, stencil, recompute_ap, stream);
}

}  // extern "C"
