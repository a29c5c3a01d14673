"""The whole-solve CG kernel (``csrc/wholesolve.cu``): its launch, its
plain torch version and the wrapper body shared by K5 (``megakernel.py``)
and K6 (``streamkernel.py``), which differ only in ``recompute_ap``.

One launch runs the entire solve; the scalars (alpha, beta, normr, k, the
trace) advance on the card, and the host reads the result back once. The
state it leaves is a :class:`CGScalars`, as the per-iteration backends
leave it, so ``solver._result`` builds the CGResult the same way.

bf16 state: vectors in bf16, reductions, scalars and the trace in float32
(``config.scalar_dtype``). The plain version rounds to the vector dtype at
the kernel's places: p' when it is formed, Ap' when K5 stores it, r and x
when they are stored; p'.Ap' takes the unrounded A p'. For float32 and
float64 every rounding is the identity, and the plain version is the
recurrence of ``solver.cg_solve``.
"""

from __future__ import annotations

import torch

from hpccg_tpu_torch.config import SUPPORTED_DTYPES, scalar_dtype
from hpccg_tpu_torch.operators import StencilOperator, apply_grid
from hpccg_tpu_torch.ops.cuda import check_tensors
from hpccg_tpu_torch.ops.cuda.build import check_launch, load_library
from hpccg_tpu_torch.ops.cuda.fused_cg import (
    IC_ACTIVE,
    SC_ALPHA,
    SC_BETA,
    STEP_INIT,
    STEP_PAP,
    STEP_RR,
    CGScalars,
    cg_finalize_plain,
)

_DTYPE_CODE = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2}


def num_blocks(op: StencilOperator, dtype, recompute_ap: bool) -> int:
    """Blocks of the kernel's cooperative grid on the current CUDA device
    (all resident at once: occupancy x SMs, capped by the work items)."""
    n = load_library().hpccg_wholesolve_num_blocks(op.nx, op.ny, op.nz, _DTYPE_CODE[dtype],
                                                   op.stencil.value, int(recompute_ap))
    if n <= 0:
        raise RuntimeError(f"whole-solve kernel: no cooperative grid (CUDA error {-n})")
    return n


def work_items(op: StencilOperator) -> int:
    """(x-tile, y-tile, z-chunk) work items of the kernel for op's grid; the
    blocks take them in turns, so a block runs more than one when there are
    more items than blocks."""
    return load_library().hpccg_wholesolve_work_items(op.nx, op.ny, op.nz)


def check(op: StencilOperator, b, x0) -> None:
    """Raise unless b and x0 are what the kernel takes."""
    n = (op.local_nrow,)
    check_tensors(b, SUPPORTED_DTYPES, b=(b, n, None), x0=(x0, n, None))
    if b.data_ptr() == x0.data_ptr():
        raise ValueError("b and x0 must not alias")


def solve_plain(op: StencilOperator, b, x0, *, max_iter: int, tolerance: float,
                recompute_ap: bool):
    """Plain torch whole solve: the kernel's recurrence and rounding, the
    exit test read back to the host once per iteration. Returns a
    CGResult."""
    from hpccg_tpu_torch.solver import _result

    vdt, sdt = b.dtype, scalar_dtype(b.dtype)
    st = CGScalars.new(sdt, max_iter, tolerance, b.device)

    def A(v):  # A v in the scalar dtype
        return apply_grid(op.grid(v.to(sdt)), op.stencil).reshape(-1)

    def dot(u, v):
        return torch.dot(u.to(sdt), v.to(sdt)).reshape(1)

    x, p = x0.clone(), x0.clone()
    r = (b.to(sdt) - A(x0)).to(vdt)
    cg_finalize_plain(dot(r, r), st, STEP_INIT)
    while int(st.ic[IC_ACTIVE]) != 0:
        p = (r.to(sdt) + st.sc[SC_BETA] * p.to(sdt)).to(vdt)
        ap = A(p)
        cg_finalize_plain(dot(p, ap), st, STEP_PAP)
        alpha = st.sc[SC_ALPHA]
        if not recompute_ap:
            ap = ap.to(vdt).to(sdt)  # K5 stores Ap' in the vector dtype
        r = (r.to(sdt) - alpha * ap).to(vdt)
        x = (x.to(sdt) + alpha * p.to(sdt)).to(vdt)
        cg_finalize_plain(dot(r, r), st, STEP_RR)
    return _result(x, st)


def launch(op: StencilOperator, b, x0, *, max_iter: int, tolerance: float, recompute_ap: bool):
    """The whole solve in one cooperative launch on b's CUDA device, on the
    current stream, without synchronising. Returns (x, the final
    CGScalars)."""
    sdt = scalar_dtype(b.dtype)
    st = CGScalars.new(sdt, max_iter, tolerance, b.device)
    blocks = num_blocks(op, b.dtype, recompute_ap)
    x, r, p0, p1 = (torch.empty_like(b) for _ in range(4))
    ap = None if recompute_ap else torch.empty_like(b)
    parts = torch.empty((2 * blocks,), dtype=sdt, device=b.device)
    lib = load_library()
    fn = {torch.float32: lib.hpccg_wholesolve_f32, torch.float64: lib.hpccg_wholesolve_f64,
          torch.bfloat16: lib.hpccg_wholesolve_bf16}[b.dtype]
    # the C entry points launch on the current device, which must be the stream's
    with torch.cuda.device(b.device):
        err = fn(b.data_ptr(), x0.data_ptr(), x.data_ptr(), r.data_ptr(), p0.data_ptr(), p1.data_ptr(),
                 None if ap is None else ap.data_ptr(), parts.data_ptr(), parts.numel(),
                 st.sc.data_ptr(), st.ic.data_ptr(), st.trace.data_ptr(),
                 op.nx, op.ny, op.nz, op.stencil.value, int(recompute_ap),
                 torch.cuda.current_stream(b.device).cuda_stream)
    check_launch(err, "whole-solve kernel (cooperative launch)")
    return x, st


def solve(wrapper, op: StencilOperator, b, x0, *, max_iter: int, tolerance: float,
          recompute_ap: bool):
    """The body of K5's and K6's wrappers: the plain version for CPU
    tensors; for CUDA tensors one launch, counted in ``wrapper.launches``.
    Returns a CGResult."""
    from hpccg_tpu_torch.solver import _result

    check(op, b, x0)
    if b.device.type == "cpu":
        return solve_plain(op, b, x0, max_iter=max_iter, tolerance=tolerance, recompute_ap=recompute_ap)
    x, st = launch(op, b, x0, max_iter=max_iter, tolerance=tolerance, recompute_ap=recompute_ap)
    wrapper.launches += 1
    return _result(x, st)
