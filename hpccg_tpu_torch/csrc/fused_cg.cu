// Fused CG update and scalar finalize kernels for Hopper (sm_90a).
//
// update_x_r (K4) replaces hpccg_tpu/ops/pallas/fused_cg.py:_k2:
//   x += alpha p;  r -= alpha Ap;  per-block partials of r.r
// x and r are updated in place (fused_cg.py:231 aliases them too); alpha is
// read through a device pointer.
//
// finalize is the scalar step that the TPU kernels kept in SMEM and the
// jitted while_loop's carry (solver.py:94-137, :349-362). One block sums the
// partials of K2/K3/K4 in a fixed order and advances the CG recurrence on
// the device: alpha = rtrans / p.Ap, beta = rr_new / rr_old,
// normr = sqrt(rtrans), trace[k], the `active` flag and k. No scalar leaves
// the card inside an iteration; the host reads `active` only every few
// iterations to stop launching.
//
// What bounds K4 on the card: memory bandwidth. It reads x, r, p, Ap and
// writes x, r: 6 vectors, 24 MB per iteration at 100^3 f32 (~7 us at
// 3.35 TB/s); the finalize step is one block and is bound by its launch.
// What the design does about it: one grid-stride pass with coalesced loads,
// the r.r reduction folded into the pass (no second read of r), a bounded
// grid so the partials stay few, and the partial sums deterministic (fixed
// tree in each block, fixed order in finalize; no float atomics).
//
// The scalar state lives in two small device arrays (cg_scalars.cuh):
//   sc[T]:   rtrans (current), rtrans (previous), alpha, beta, normr, tol
//   ic[int]: k, active, max_iter
// Exit semantics follow the reference loop `for k=1; k<max_iter &&
// normr>tol`: the test uses the normr computed at the top of the previous
// body, not the newest r.r (solver.py:94-137). Iteration k runs iff
// k < max_iter and normr_{k-1} > tol.

#include "cg_scalars.cuh"
#include "reduce.cuh"

namespace {

constexpr int NT = 256;
constexpr long long K4_MAX_BLOCKS = 1056;  // 8 blocks on each of 132 SMs

using namespace hpccg;
enum { STEP_INIT = 0, STEP_PAP = 1, STEP_RR = 2 };

template <typename T>
__global__ void __launch_bounds__(NT)
    update_x_r_kernel(T* __restrict__ x, T* __restrict__ r, const T* __restrict__ p,
                      const T* __restrict__ ap, const T* alpha_ptr, T* __restrict__ partials,
                      const int* active, int64_t n) {
  if (active != nullptr && *active == 0) return;
  __shared__ T red[NT];
  const T a = *alpha_ptr;
  T acc = T(0);
  const int64_t stride = (int64_t)gridDim.x * NT;
  for (int64_t i = (int64_t)blockIdx.x * NT + threadIdx.x; i < n; i += stride) {
    x[i] = x[i] + a * p[i];
    const T rn = r[i] - a * ap[i];
    r[i] = rn;
    acc += rn * rn;
  }
  const T total = hpccg::block_sum<T, NT>(acc, red, threadIdx.x);
  if (threadIdx.x == 0) partials[blockIdx.x] = total;
}

// The top of CG body k: test the exit, then beta, normr and trace[k].
template <typename T>
__device__ void top_of_body(T* sc, int* ic, T* trace) {
  const int k = ic[IC_K];
  const bool go = k < ic[IC_MAX_ITER] && sc[SC_NORMR] > sc[SC_TOL];
  ic[IC_ACTIVE] = go ? 1 : 0;
  if (go) {
    sc[SC_BETA] = (k == 1) ? T(0) : sc[SC_RT_CUR] / sc[SC_RT_PREV];
    const T normr = sqrt(sc[SC_RT_CUR]);
    sc[SC_NORMR] = normr;
    trace[k] = normr;
  } else {
    // zero steps keep the plain-torch axpys of the `pallas` backend no-ops
    sc[SC_ALPHA] = T(0);
    sc[SC_BETA] = T(0);
  }
}

template <typename T>
__global__ void __launch_bounds__(NT)
    finalize_kernel(const T* __restrict__ partials, int nparts, T* sc, int* ic, T* trace,
                    int step) {
  if (step != STEP_INIT && ic[IC_ACTIVE] == 0) return;
  __shared__ T red[NT];
  T acc = T(0);
  for (int i = threadIdx.x; i < nparts; i += NT) acc += partials[i];
  const T s = hpccg::block_sum<T, NT>(acc, red, threadIdx.x);
  if (threadIdx.x != 0) return;
  if (step == STEP_INIT) {  // s = r0.r0
    sc[SC_RT_CUR] = s;
    sc[SC_RT_PREV] = s;
    sc[SC_NORMR] = sqrt(s);
    trace[0] = sc[SC_NORMR];
    ic[IC_K] = 1;
    top_of_body(sc, ic, trace);
  } else if (step == STEP_PAP) {  // s = p.Ap
    sc[SC_ALPHA] = sc[SC_RT_CUR] / s;
  } else {  // s = r.r after the update: the end of body k
    sc[SC_RT_PREV] = sc[SC_RT_CUR];
    sc[SC_RT_CUR] = s;
    ic[IC_K] += 1;
    top_of_body(sc, ic, trace);
  }
}

int update_blocks(long long n) {
  const long long b = (n + NT - 1) / NT;
  return (int)(b < K4_MAX_BLOCKS ? (b < 1 ? 1 : b) : K4_MAX_BLOCKS);
}

template <typename T>
int launch_update(T* x, T* r, const T* p, const T* ap, const T* alpha, T* partials,
                  const int* active, long long n, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  update_x_r_kernel<T><<<update_blocks(n), NT, 0, (cudaStream_t)stream>>>(x, r, p, ap, alpha,
                                                                          partials, active, n);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_finalize(const T* partials, int nparts, T* sc, int* ic, T* trace, int step,
                    void* stream) {
  if (nparts < 1 || step < STEP_INIT || step > STEP_RR) return (int)cudaErrorInvalidValue;
  finalize_kernel<T><<<1, NT, 0, (cudaStream_t)stream>>>(partials, nparts, sc, ic, trace, step);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Number of blocks (= partials written by K4) for n elements.
int hpccg_update_num_blocks(long long n) { return update_blocks(n); }

int hpccg_update_x_r_f32(float* x, float* r, const float* p, const float* ap, const float* alpha,
                         float* partials, const int* active, long long n, void* stream) {
  return launch_update<float>(x, r, p, ap, alpha, partials, active, n, stream);
}

int hpccg_update_x_r_f64(double* x, double* r, const double* p, const double* ap,
                         const double* alpha, double* partials, const int* active, long long n,
                         void* stream) {
  return launch_update<double>(x, r, p, ap, alpha, partials, active, n, stream);
}

int hpccg_finalize_f32(const float* partials, int nparts, float* sc, int* ic, float* trace,
                       int step, void* stream) {
  return launch_finalize<float>(partials, nparts, sc, ic, trace, step, stream);
}

int hpccg_finalize_f64(const double* partials, int nparts, double* sc, int* ic, double* trace,
                       int step, void* stream) {
  return launch_finalize<double>(partials, nparts, sc, ic, trace, step, stream);
}

}  // extern "C"
