// The CG update x += alpha p, r -= alpha Ap with the new r.r: the body of
// K4 (fused_cg.cu), one grid-stride pass over the flat vectors, and of K5's
// phase B (wholesolve.cu), on its tiles' rows.
//
// update_one / update_vec: one element, or one 16-byte vector of each array
// (V = 16 / sizeof(T) elements). Both updates are rounded one operation at
// a time (no FMA contraction), as the plain torch version computes them;
// r.r adds the stored r's squares in S (K4), or each square rounded to S in
// the wider A (add_square; K5's per-plane partials).
//
// update_x_r_range (K4): two vectors of each array in flight per thread
// and step, a scalar head up to the first 16-byte boundary and a scalar
// tail (a view at any element offset: where the four arrays' offsets
// differ, every element is scalar).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "reduce.cuh"
#include "storage.cuh"

namespace hpccg {

// acc += v * v: in S as one expression where acc is S (K4), else the
// square rounded to S and added in the wider A (wholesolve.cu).
template <typename S, typename A>
__device__ __forceinline__ void add_square(A& acc, S v) {
  if constexpr (std::is_same_v<A, S>) {
    acc += v * v;
  } else {
    acc += A(mul_rn(v, v));
  }
}

// One element of the update; adds the stored r's square to acc.
template <typename T, typename S, typename A>
__device__ __forceinline__ void update_one(T& x, T& r, T p, T ap, S a, A& acc) {
  x = from_s<T>(add_rn(to_s(x), mul_rn(a, to_s(p))));
  const S rn = to_s(from_s<T>(add_rn(to_s(r), -mul_rn(a, to_s(ap)))));
  r = from_s<T>(rn);
  add_square(acc, rn);
}

// The update on one 16-byte vector of each array (V elements).
template <typename T, typename S, typename A>
__device__ __forceinline__ void update_vec(uint4& xq, uint4& rq, const uint4& pq, const uint4& aq, S a,
                                           A& acc) {
  constexpr int V = 16 / (int)sizeof(T);
  T* xe = reinterpret_cast<T*>(&xq);
  T* re = reinterpret_cast<T*>(&rq);
  const T* pe = reinterpret_cast<const T*>(&pq);
  const T* ae = reinterpret_cast<const T*>(&aq);
#pragma unroll
  for (int j = 0; j < V; ++j) update_one<T, S, A>(xe[j], re[j], pe[j], ae[j], a, acc);
}

// The update over elements [0, n) by thread `tid` of `stride` threads;
// returns the thread's share of r.r. Elements [head, head + V * nvec) are
// 16-byte vectors of every array (head: the elements before the first
// 16-byte boundary, the same in all four; n when their offsets differ);
// the head and the tail after the last whole vector go one element at a
// time.
template <typename T, typename S>
__device__ __forceinline__ S update_x_r_range(T* __restrict__ x, T* __restrict__ r, const T* __restrict__ p,
                                              const T* __restrict__ ap, S a, int64_t n, int64_t head,
                                              int64_t tid, int64_t stride) {
  constexpr int V = 16 / (int)sizeof(T);
  S acc = S(0);
  const int64_t nvec = (n - head) / V;
  for (int64_t i = tid; i < head; i += stride) update_one<T, S, S>(x[i], r[i], p[i], ap[i], a, acc);
  for (int64_t i = head + nvec * V + tid; i < n; i += stride) update_one<T, S, S>(x[i], r[i], p[i], ap[i], a, acc);
  uint4* xv = reinterpret_cast<uint4*>(x + head);
  uint4* rv = reinterpret_cast<uint4*>(r + head);
  const uint4* pv = reinterpret_cast<const uint4*>(p + head);
  const uint4* av = reinterpret_cast<const uint4*>(ap + head);
  // two vectors of each array in flight per thread and step
  for (int64_t i = tid; i < nvec; i += 2 * stride) {
    const int64_t j = i + stride;
    const bool two = j < nvec;
    uint4 x0 = xv[i], r0 = rv[i], p0 = pv[i], a0 = av[i];
    uint4 x1, r1, p1, a1;
    if (two) {
      x1 = xv[j];
      r1 = rv[j];
      p1 = pv[j];
      a1 = av[j];
    }
    update_vec<T, S, S>(x0, r0, p0, a0, a, acc);
    xv[i] = x0;
    rv[i] = r0;
    if (two) {
      update_vec<T, S, S>(x1, r1, p1, a1, a, acc);
      xv[j] = x1;
      rv[j] = r1;
    }
  }
  return acc;
}

// The elements before the first 16-byte boundary, where all four arrays
// share their offset from it; n (no vectors) where they do not.
template <typename T>
inline long long vector_head(const void* x, const void* r, const void* p, const void* ap, long long n) {
  const uintptr_t m = (uintptr_t)x % 16;
  if ((uintptr_t)r % 16 != m || (uintptr_t)p % 16 != m || (uintptr_t)ap % 16 != m || m % sizeof(T) != 0) {
    return n;
  }
  const long long h = (long long)((16 - m) % 16 / sizeof(T));
  return h < n ? h : n;
}

}  // namespace hpccg
