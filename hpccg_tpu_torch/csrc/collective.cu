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
// The ranks, the protocol (rank barriers, halo phases, the allreduce), the
// bounded waits and the cg and cg1 drivers are shared with K17 and live in
// collective.cuh. This file holds the stencil's view of a rank (the halo is
// planes: the pass that produces a vector writes its first real plane into
// the below-neighbour's landing plane and its last into the
// above-neighbour's, (5, 2, ny, nx) landing planes per rank), K16's
// pipelined driver and the entry points.
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

#include <cuda_runtime.h>
#include <stdint.h>

#include "collective.cuh"
#include "stencil_tile.cuh"
#include "storage.cuh"

namespace {

using namespace hpccg::coll;
using hpccg::from_s;
using hpccg::to_s;
using hpccg::TILE_NT;
using hpccg::TILE_X;
using hpccg::TILE_Y;
constexpr int CZ = 8;  // z-planes per work item

template <typename S>
struct Params {
  Common<S> c;
  int nx, ny, nz;
};

long long work_items(int nx, int ny, int nz) {
  return (long long)ceil_div(nx, TILE_X) * ceil_div(ny, TILE_Y) * ceil_div(nz, CZ);
}

// One block's view of its rank of the z-stacked stencil problem: vectors
// and landing planes in T, the tile and the arithmetic in S.
template <typename T, typename S, int STENCIL>
struct Rank : Comm<T, S, TILE_NT> {
  using Base = Comm<T, S, TILE_NT>;
  S (*tile)[TILE_X + 2];
  int nx, ny, nz;
  int64_t plane;
  int tiles_x, tiles_y, items;

  __device__ Rank(const Params<S>& p, S (*t)[TILE_X + 2], S* r)
      : Base(p.c, r, threadIdx.y * TILE_X + threadIdx.x, (int64_t)p.nx * p.ny * p.nz), tile(t) {
    nx = p.nx;
    ny = p.ny;
    nz = p.nz;
    plane = (int64_t)nx * ny;
    tiles_x = ceil_div(nx, TILE_X);
    tiles_y = ceil_div(ny, TILE_Y);
    items = tiles_x * tiles_y * ceil_div(nz, CZ);
  }

  // Real element i of a vector goes to the neighbours' landing planes of
  // phase ph.
  __device__ void push(int ph, int64_t i, T v) {
    const int rank = this->rank;
    if (i < plane && rank > 0) this->template ptr<T>(P_H, rank - 1)[(2 * ph + 1) * plane + i] = v;
    if (i >= this->n - plane && rank < this->ndev - 1) {
      this->template ptr<T>(P_H, rank + 1)[2 * ph * plane + i - (this->n - plane)] = v;
    }
  }

  // A v over the rank's slab, with phase ph's landing planes as the planes
  // at z = -1 and z = nz: emit(i, c, y) with c = v[i], y = (A v)[i].
  template <typename Emit>
  __device__ void apply(int kind, int ph, Emit&& emit) {
    const T* v = this->vec(kind);
    const T* lo = this->template ptr<T>(P_H, this->rank) + 2 * ph * plane;
    const T* hi = lo + plane;
    for (int it = this->lb; it < items; it += this->bpr) {
      const int cz = it / (tiles_x * tiles_y), rem = it % (tiles_x * tiles_y);
      const int bx0 = (rem % tiles_x) * TILE_X, by0 = (rem / tiles_x) * TILE_Y;
      const int ix = bx0 + threadIdx.x, iy = by0 + threadIdx.y;
      const bool inside = ix < nx && iy < ny;
      const int64_t inplane = (int64_t)iy * nx + ix;
      const int z0 = cz * CZ;
      hpccg::march_tile<S, STENCIL>(
          tile, bx0, by0, z0, min(z0 + CZ, nz),
          [&](int zz, int gy, int gx) -> S {
            if (gx < 0 || gx >= nx || gy < 0 || gy >= ny) return S(0);
            const T* src = zz < 0 ? lo : (zz >= nz ? hi : v + (int64_t)zz * plane);
            return to_s(__ldcg(src + (int64_t)gy * nx + gx));
          },
          [&](int z, S c, S y) {
            if (inside) emit((int64_t)z * plane + inplane, c, y);
          });
    }
  }
};

// K16, pipecg (_kernel_pipelined): W = A r, S = A p, Z = A s by recurrence,
// Q = A w the one apply of a body, run while the body's allreduce is in
// flight.
template <typename T, typename S, int STENCIL>
__device__ void solve_pipecg(Rank<T, S, STENCIL>& R) {
  const T* b = R.template ptr<T>(P_B, R.rank);
  const T* x0 = R.template ptr<T>(P_X0, R.rank);
  T *X = R.vec(P_X), *Rv = R.vec(P_R), *W = R.vec(P_U), *Pv = R.vec(P_P), *Sv = R.vec(P_S);
  T *Z = R.vec(P_Z), *Q = R.vec(P_Q);
  R.each([&](int64_t i) {
    const T v = x0[i];
    X[i] = v;
    R.push(0, i, v);
  });
  HPCCG_TRY(R.exchange(0));
  R.apply(P_X, 0, [&](int64_t i, S, S y) {
    const T r = from_s<T>(to_s(b[i]) - y);
    Rv[i] = r;
    R.push(1, i, r);
  });
  HPCCG_TRY(R.exchange(1));
  S g = S(0), d = S(0);
  R.apply(P_R, 1, [&](int64_t i, S c, S y) {
    const T w = from_s<T>(y);
    W[i] = w;
    g += c * c;
    d += y * c;
    R.push(2, i, w);
  });
  HPCCG_TRY(R.exchange(2));
  HPCCG_TRY(R.allreduce_start(g, d, 0));
  R.apply(P_U, 2, [&](int64_t i, S, S y) { Q[i] = from_s<T>(y); });
  HPCCG_TRY(R.rank_barrier());  // Q complete before the first pass reads it
  S gamma, delta;
  HPCCG_TRY(R.allreduce_finish(0, gamma, delta));
  if (R.leader) R.P.trace[0] = sqrt(gamma);
  S alpha = gamma / delta, gamma_top = gamma, beta = S(0);
  int k = 1;
  while (k < R.P.max_iter && sqrt(gamma_top) > R.P.tol) {
    if (R.leader) R.P.trace[k] = sqrt(gamma);
    const bool first = k == 1;
    const int ph = 3 + (k & 1), slot = k & 1;
    g = S(0);
    d = S(0);
    R.each([&](int64_t i) {
      const S rv = to_s(__ldcg(Rv + i)), wv = to_s(__ldcg(W + i)), qv = to_s(__ldcg(Q + i));
      const T p = from_s<T>(first ? rv : rv + beta * to_s(__ldcg(Pv + i)));
      const T s = from_s<T>(first ? wv : wv + beta * to_s(__ldcg(Sv + i)));
      const T z = from_s<T>(first ? qv : qv + beta * to_s(__ldcg(Z + i)));
      Pv[i] = p;
      Sv[i] = s;
      Z[i] = z;
      X[i] = from_s<T>(to_s(__ldcg(X + i)) + alpha * to_s(p));
      const T r = from_s<T>(rv - alpha * to_s(s));
      const T w = from_s<T>(wv - alpha * to_s(z));
      Rv[i] = r;
      W[i] = w;
      const S rs = to_s(r), ws = to_s(w);
      g += rs * rs;
      d += ws * rs;
      R.push(ph, i, w);
    });
    HPCCG_TRY(R.exchange(ph));
    HPCCG_TRY(R.allreduce_start(g, d, slot));
    R.apply(P_U, ph, [&](int64_t i, S, S y) { Q[i] = from_s<T>(y); });  // hides the allreduce
    HPCCG_TRY(R.rank_barrier());  // W read and Q written before the next pass
    S g_new, dl;
    HPCCG_TRY(R.allreduce_finish(slot, g_new, dl));
    beta = g_new / gamma;
    alpha = g_new / (dl - beta * g_new / alpha);
    gamma_top = gamma;
    gamma = g_new;
    ++k;
  }
  R.finish(sqrt(gamma_top), gamma_top, k);
}

// The launch bound follows the compute type S: float cg (float32 and
// bfloat16 vectors) fits in 80 registers, 3 blocks per SM; the other
// instances are held to 128 registers, 2 blocks per SM
template <typename T, typename S, int STENCIL, int METHOD>
__global__ void __launch_bounds__(TILE_NT, METHOD == CG && sizeof(S) == 4 ? 3 : 2)
    collective_kernel(const Params<S> P) {
  __shared__ S tile[TILE_Y + 2][TILE_X + 2];
  __shared__ S red[TILE_NT];
  Rank<T, S, STENCIL> R(P, tile, red);
  if (METHOD == CG) {
    solve_cg(R);
  } else if (METHOD == CG1) {
    solve_cg1(R);
  } else {
    solve_pipecg(R);
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

// Blocks of kernel<T, S>(stencil, method) resident at once on the current
// device (occupancy x SMs). Returns a CUDA error code.
template <typename T, typename S>
int resident_blocks(int stencil, int method, int* blocks) {
  if ((stencil != 27 && stencil != 7) || method < CG || method > PIPECG) return (int)cudaErrorInvalidValue;
  return occupancy_blocks(kernel_for<T, S>(stencil, method), TILE_NT, blocks);
}

template <typename T, typename S>
int launch(const long long* ptrs, S* trace, S* stats, int* err, int ndev, int bpr, int nx, int ny, int nz,
           int stencil, int method, int max_iter, double tol, long long wait_ns, void* stream) {
  int resident = 0;
  const int e = resident_blocks<T, S>(stencil, method, &resident);
  if (e != (int)cudaSuccess) return e;
  if (ndev < 1 || bpr < 1 || nx < 1 || ny < 1 || nz < 1 || wait_ns < 0) return (int)cudaErrorInvalidValue;
  if ((long long)ndev * bpr > resident) return (int)cudaErrorCooperativeLaunchTooLarge;
  Params<S> params{{ptrs, trace, stats, err, ndev, bpr, max_iter, S(tol), (unsigned long long)wait_ns}, nx, ny,
                   nz};
  void* args[] = {&params};
  return (int)cudaLaunchCooperativeKernel(kernel_for<T, S>(stencil, method), dim3(ndev * bpr),
                                          dim3(TILE_X, TILE_Y), args, 0, (cudaStream_t)stream);
}

}  // namespace

extern "C" {

// Blocks resident at once for the kernel (dtype 0 float32, 1 float64, 2
// bfloat16; method 0 cg, 1 cg1, 2 pipecg), or minus a CUDA error code: the
// grid of a launch is ndev x bpr blocks and must not exceed it.
int hpccg_collective_resident_blocks(int dtype, int stencil, int method) {
  int blocks = 0;
  int err = (int)cudaErrorInvalidValue;
  if (dtype == 0) err = resident_blocks<float, float>(stencil, method, &blocks);
  if (dtype == 1) err = resident_blocks<double, double>(stencil, method, &blocks);
  if (dtype == 2) err = resident_blocks<__nv_bfloat16, float>(stencil, method, &blocks);
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
  return launch<float, float>(ptrs, trace, stats, err, ndev, bpr, nx, ny, nz, stencil, method, max_iter, tol,
                              wait_ns, stream);
}

int hpccg_collective_f64(const long long* ptrs, double* trace, double* stats, int* err, int ndev, int bpr, int nx,
                         int ny, int nz, int stencil, int method, int max_iter, double tol, long long wait_ns,
                         void* stream) {
  return launch<double, double>(ptrs, trace, stats, err, ndev, bpr, nx, ny, nz, stencil, method, max_iter, tol,
                                wait_ns, stream);
}

// bfloat16 vectors (the b, x0 and state rows of ptrs, the landing planes);
// the partials, the allreduce table, the trace and the stats are float32.
int hpccg_collective_bf16(const long long* ptrs, float* trace, float* stats, int* err, int ndev, int bpr, int nx,
                          int ny, int nz, int stencil, int method, int max_iter, double tol, long long wait_ns,
                          void* stream) {
  return launch<__nv_bfloat16, float>(ptrs, trace, stats, err, ndev, bpr, nx, ny, nz, stencil, method, max_iter,
                                      tol, wait_ns, stream);
}

}  // extern "C"
