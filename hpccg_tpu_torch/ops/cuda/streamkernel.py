"""K6, the whole-solve kernel that never materialises Ap
(``csrc/wholesolve.cu``, ``RECOMPUTE_AP = true``): the port of
``streamkernel._kernel``, backend ``streamkernel``. The stencil is applied
to p' twice per iteration, once for p'.Ap' and once for the r update.

``cg_solve_stream`` runs its plain version only for CPU tensors; for CUDA
tensors it makes one cooperative launch per solve or raises, and counts its
launches in ``cg_solve_stream.launches``.
"""

from __future__ import annotations

from hpccg_tpu_torch.ops.cuda import wholesolve


def cg_solve_stream_plain(op, b, x0, *, max_iter: int, tolerance: float = 0.0):
    """Plain torch K6: the whole solve, A p' recomputed for the r update."""
    return wholesolve.solve_plain(op, b, x0, max_iter=max_iter, tolerance=tolerance, recompute_ap=True)


def cg_solve_stream(op, b, x0, *, max_iter: int, tolerance: float = 0.0):
    """K6: the whole CG solve in one launch, Ap recomputed (flat (n,)
    vectors; float32, float64 or bfloat16 state). Returns a CGResult."""
    return wholesolve.solve(cg_solve_stream, op, b, x0, max_iter=max_iter, tolerance=tolerance,
                            recompute_ap=True)


cg_solve_stream.launches = 0
