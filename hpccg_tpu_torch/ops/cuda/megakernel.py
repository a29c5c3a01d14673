"""K5, the whole-solve kernel with Ap materialised (``csrc/wholesolve.cu``,
``RECOMPUTE_AP = false``): the port of ``megakernel._kernel`` and
``_kernel_slab``, backend ``megakernel``.

``cg_solve_mega`` runs its plain version only for CPU tensors; for CUDA
tensors it makes one cooperative launch per solve or raises, and counts its
launches in ``cg_solve_mega.launches``; float32 and bf16 launches are counted in
``cg_solve_mega.launches_f32`` and ``cg_solve_mega.launches_bf16`` as well.
"""

from __future__ import annotations

from hpccg_tpu_torch.ops.cuda import wholesolve


def cg_solve_mega_plain(op, b, x0, *, max_iter: int, tolerance: float = 0.0):
    """Plain torch K5: the whole solve, Ap' stored in the vector dtype."""
    return wholesolve.solve_plain(op, b, x0, max_iter=max_iter, tolerance=tolerance, recompute_ap=False)


def cg_solve_mega(op, b, x0, *, max_iter: int, tolerance: float = 0.0):
    """K5: the whole CG solve in one launch (flat (n,) vectors; float32,
    float64 or bfloat16 state). Returns a CGResult."""
    return wholesolve.solve(cg_solve_mega, op, b, x0, max_iter=max_iter, tolerance=tolerance,
                            recompute_ap=False)


cg_solve_mega.launches = 0
cg_solve_mega.launches_f32 = 0
cg_solve_mega.launches_bf16 = 0
