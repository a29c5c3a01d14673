// Indices into the CG scalar state shared by the finalize kernel
// (fused_cg.cu) and the whole-solve kernel (wholesolve.cu); the same
// numbers as hpccg_tpu_torch/ops/cuda/fused_cg.py.
//   sc[S]:   rtrans (current), rtrans (previous), alpha, beta, normr, tol
//   ic[int]: k, active, max_iter
#pragma once

namespace hpccg {

enum { SC_RT_CUR = 0, SC_RT_PREV = 1, SC_ALPHA = 2, SC_BETA = 3, SC_NORMR = 4, SC_TOL = 5 };
enum { IC_K = 0, IC_ACTIVE = 1, IC_MAX_ITER = 2 };

}  // namespace hpccg
