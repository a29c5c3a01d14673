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

The dot products have the TPU kernels' form, a partial per z-slab added
along z in the scalar dtype, with a slab of one plane (``plane_dot``):
each plane's products, rounded to the scalar dtype, are added in float64
and the plane's sum is rounded once; the plane sums are added in the
scalar dtype in z order. The plane sums do not depend on the order of
their terms, so the kernel computes the same scalars on the card as this
version does there or on the CPU, which the CPU tests hold against the JAX
kernels. A stagnating bf16 recurrence turns a last-bit difference of alpha
into x elements rounded the other way: with float32 sums in other orders
the plain version parted from itself (an H100 against the CPU) in up to
14% of x within 30 iterations (PERF.md).
"""

from __future__ import annotations

import ctypes
import dataclasses

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


@dataclasses.dataclass(frozen=True)
class WholeSolveGeometry:
    """The kernel's cooperative grid for a solve: the tile (x points, y
    rows), the z-planes of a work item, the work items and the blocks."""

    tile_x: int
    tile_y: int
    z_chunk: int
    items: int
    blocks: int


def geometry(op: StencilOperator, dtype=None, recompute_ap: bool = False) -> WholeSolveGeometry:
    """The cooperative grid of K5 (K6 with ``recompute_ap``) for op's grid in
    ``dtype`` (default ``op.dtype``; the tile is 16 bytes a thread wide) on
    the current CUDA device: all blocks resident at once (occupancy x SMs),
    capped by the work items; the blocks take the items in turns."""
    out = (ctypes.c_int * 5)()
    err = load_library().hpccg_wholesolve_geometry(op.nx, op.ny, op.nz, _DTYPE_CODE[dtype or op.dtype],
                                                   op.stencil.value, int(recompute_ap), ctypes.addressof(out))
    if err != 0:
        raise RuntimeError(f"whole-solve kernel: no cooperative grid (CUDA error {err})")
    return WholeSolveGeometry(*out)


def num_blocks(op: StencilOperator, dtype=None, recompute_ap: bool = False) -> int:
    """Blocks of the kernel's cooperative grid (``geometry``)."""
    return geometry(op, dtype, recompute_ap).blocks


def work_items(op: StencilOperator, dtype=None, recompute_ap: bool = False) -> int:
    """(x-tile, y-tile, z-chunk) work items of the kernel (``geometry``); a
    block runs more than one when there are more items than blocks."""
    return geometry(op, dtype, recompute_ap).items


def check(op: StencilOperator, b, x0) -> None:
    """Raise unless b and x0 are what the kernel takes."""
    n = (op.local_nrow,)
    check_tensors(b, SUPPORTED_DTYPES, b=(b, n, None), x0=(x0, n, None))
    if b.data_ptr() == x0.data_ptr():
        raise ValueError("b and x0 must not alias")


def plane_dot(u, v, nz: int, sdt):
    """u . v as the kernel sums it, in ``sdt``: the products rounded to sdt,
    each of the nz z-planes' products added in float64 and rounded to sdt
    once, the plane sums added in sdt in z order (on the host, whose float
    arithmetic is the card's). Returns a tensor of shape (1,) on u's
    device."""
    planes = (u.to(sdt) * v.to(sdt)).to(torch.float64).reshape(nz, -1).sum(1).to(sdt).cpu().numpy()
    acc = planes.dtype.type(0)
    for t in planes:
        acc = acc + t
    return torch.tensor([acc], dtype=sdt, device=u.device)


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
        return plane_dot(u, v, op.nz, sdt)

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
    g = geometry(op, b.dtype, recompute_ap)
    tiles = -(-op.nx // g.tile_x) * -(-op.ny // g.tile_y)
    x, r, p0, p1 = (torch.empty_like(b) for _ in range(4))
    ap = None if recompute_ap else torch.empty_like(b)
    # per dot: the (tile, plane) partials and the plane sums; a ticket per z chunk
    parts = torch.empty((2 * op.nz * (tiles + 1),), dtype=torch.float64, device=b.device)
    tickets = torch.zeros((2 * -(-op.nz // g.z_chunk),), dtype=torch.int32, device=b.device)
    lib = load_library()
    fn = {torch.float32: lib.hpccg_wholesolve_f32, torch.float64: lib.hpccg_wholesolve_f64,
          torch.bfloat16: lib.hpccg_wholesolve_bf16}[b.dtype]
    # the C entry points launch on the current device, which must be the stream's
    with torch.cuda.device(b.device):
        err = fn(b.data_ptr(), x0.data_ptr(), x.data_ptr(), r.data_ptr(), p0.data_ptr(), p1.data_ptr(),
                 None if ap is None else ap.data_ptr(), parts.data_ptr(), parts.numel(), tickets.data_ptr(),
                 tickets.numel(), st.sc.data_ptr(), st.ic.data_ptr(), st.trace.data_ptr(),
                 op.nx, op.ny, op.nz, op.stencil.value, int(recompute_ap),
                 torch.cuda.current_stream(b.device).cuda_stream)
    check_launch(err, "whole-solve kernel (cooperative launch)")
    return x, st


def solve(wrapper, op: StencilOperator, b, x0, *, max_iter: int, tolerance: float,
          recompute_ap: bool):
    """The body of K5's and K6's wrappers: the plain version for CPU
    tensors; for CUDA tensors one launch, counted in ``wrapper.launches``
    and, by dtype, in ``wrapper.launches_f32`` or ``wrapper.launches_bf16``.
    Returns a CGResult."""
    from hpccg_tpu_torch.solver import _result

    check(op, b, x0)
    if b.device.type == "cpu":
        return solve_plain(op, b, x0, max_iter=max_iter, tolerance=tolerance, recompute_ap=recompute_ap)
    x, st = launch(op, b, x0, max_iter=max_iter, tolerance=tolerance, recompute_ap=recompute_ap)
    wrapper.launches += 1
    if b.dtype == torch.float32:
        wrapper.launches_f32 += 1
    if b.dtype == torch.bfloat16:
        wrapper.launches_bf16 += 1
    return _result(x, st)
