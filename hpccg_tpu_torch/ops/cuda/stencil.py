"""Stencil SpMV kernels K1, K2, K3 and K7 (``csrc/stencil.cu``): wrappers,
plain versions and launch counters.

- K1 ``spmv_stencil``: y = A u (``stencil_v2.py:_kernel``; also the product
  of ``stencil_kernel.py:_kernel``, K8);
- K2 ``spmv_stencil_pap``: (y, partials of u . y) (``stencil_v2.py:_kernel_pap``);
- K3 ``update_p_apply``: (p' = r + beta p, Ap' = A p', partials of p'. Ap')
  (``fused_cg.py:_k1``);
- K7 ``spmv_stencil_pap_dd``: K2's float64 instance, backend ``pallas_dd``
  (``stencil_v2.py:_kernel_dd`` / ``_kernel_dd_pap``, which carry f64 as
  (hi, lo) float32 pairs because the TPU has no f64; Hopper has native f64).

Vectors are contiguous (nz, ny, nx) tensors, the flat row-major layout of
the JAX package viewed as a grid. Halos are external z-planes for a shard,
(2, ny, nx) [below, above] for K1/K2 and (4, ny, nx) [r_below, r_above,
p_below, p_above] for K3; None is the domain boundary. ``beta`` is a
1-element device tensor; ``active`` an optional 1-element int32 tensor: at 0
nothing is written. ``partials`` are per-block sums that
``fused_cg.cg_finalize`` adds up; a plain version writes one partial.

Each wrapper runs its plain version only for tensors on the CPU. For CUDA
tensors it launches the kernel (on the current stream, without
synchronising) or raises; it counts its launches in ``<wrapper>.launches``.
"""

from __future__ import annotations

import torch

from hpccg_tpu_torch.operators import StencilOperator, apply_grid
from hpccg_tpu_torch.ops.cuda import check_tensors
from hpccg_tpu_torch.ops.cuda.build import check_launch, load_library


def num_partials(op: StencilOperator, device) -> int:
    """How many partials K2/K3 write on ``device`` (1 for the plain version)."""
    if torch.device(device).type != "cuda":
        return 1
    return load_library().hpccg_stencil_num_blocks(op.nx, op.ny, op.nz)


def _partials(op, ref, partials):
    n = num_partials(op, ref.device)
    if partials is None:
        return torch.empty((n,), dtype=ref.dtype, device=ref.device)
    check_tensors(ref, partials=(partials, (n,), None))
    return partials


def _inactive(active) -> bool:
    return active is not None and int(active.item()) == 0


def _apply_halo(op: StencilOperator, u: torch.Tensor, below, above) -> torch.Tensor:
    """A u on the grid, with external planes at z = -1 and z = nz."""
    if below is None:
        return apply_grid(u, op.stencil)
    ext = torch.cat([below.unsqueeze(0), u, above.unsqueeze(0)], 0)
    return apply_grid(ext, op.stencil)[1:-1]


def _no_alias(out, *inputs) -> None:
    if out is not None and any(out.data_ptr() == t.data_ptr() for t in inputs):
        raise ValueError("an output must not alias an input: blocks read neighbouring planes")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch(op, u, v, beta, halo_u, halo_v, out_p, out_y, partials, active, fuse_p, pap):
    lib = load_library()
    fn = lib.hpccg_stencil_f32 if u.dtype == torch.float32 else lib.hpccg_stencil_f64
    hb_u, ha_u = (None, None) if halo_u is None else (halo_u[0], halo_u[1])
    hb_v, ha_v = (None, None) if halo_v is None else (halo_v[0], halo_v[1])
    # the C entry points launch on the current device, which must be the stream's
    with torch.cuda.device(u.device):
        err = fn(
            _ptr(u), _ptr(v), _ptr(beta), _ptr(hb_u), _ptr(ha_u), _ptr(hb_v), _ptr(ha_v),
            _ptr(out_p), _ptr(out_y), _ptr(partials), _ptr(active),
            op.nx, op.ny, op.nz, op.stencil.value, int(fuse_p), int(pap),
            torch.cuda.current_stream(u.device).cuda_stream,
        )
    check_launch(err, "stencil kernel")


_ACTIVE = ((1,), torch.int32)


# --------------------------------------------------------------------- K1


def spmv_stencil_plain(op, u, halo=None, *, out=None, active=None):
    """Plain torch K1: y = A u."""
    if out is None:
        out = torch.empty_like(u)
    if _inactive(active):
        return out
    below, above = (None, None) if halo is None else (halo[0], halo[1])
    return out.copy_(_apply_halo(op, u, below, above))


def spmv_stencil(op: StencilOperator, u, halo=None, *, out=None, active=None):
    """K1: y = A u on the (nz, ny, nx) grid (CUDA kernel; plain on the CPU)."""
    grid = (op.nz, op.ny, op.nx)
    check_tensors(u, u=(u, grid, None), halo=(halo, (2, op.ny, op.nx), None),
                  out=(out, grid, None), active=(active, *_ACTIVE))
    _no_alias(out, u)
    if u.device.type == "cpu":
        return spmv_stencil_plain(op, u, halo, out=out, active=active)
    if out is None:
        out = torch.empty_like(u)
    _launch(op, u, None, None, halo, None, None, out, None, active, False, False)
    spmv_stencil.launches += 1
    return out


spmv_stencil.launches = 0


# --------------------------------------------------------------------- K2


def spmv_stencil_pap_plain(op, u, halo=None, *, out=None, partials=None, active=None):
    """Plain torch K2: (y = A u, [u . y])."""
    if out is None:
        out = torch.empty_like(u)
    if partials is None:
        partials = torch.empty((1,), dtype=u.dtype, device=u.device)
    if _inactive(active):
        return out, partials
    spmv_stencil_plain(op, u, halo, out=out)
    partials.copy_(torch.dot(u.reshape(-1), out.reshape(-1)).reshape(1))
    return out, partials


def _k2(counter, op, u, halo, out, partials, active):
    """K2's checks and launch, shared with K7; a launch is counted in
    ``counter.launches``."""
    grid = (op.nz, op.ny, op.nx)
    check_tensors(u, u=(u, grid, None), halo=(halo, (2, op.ny, op.nx), None),
                  out=(out, grid, None), active=(active, *_ACTIVE))
    _no_alias(out, u)
    partials = _partials(op, u, partials)
    if u.device.type == "cpu":
        return spmv_stencil_pap_plain(op, u, halo, out=out, partials=partials, active=active)
    if out is None:
        out = torch.empty_like(u)
    _launch(op, u, None, None, halo, None, None, out, partials, active, False, True)
    counter.launches += 1
    return out, partials


def spmv_stencil_pap(op: StencilOperator, u, halo=None, *, out=None, partials=None, active=None):
    """K2: (y = A u, per-block partials of u . y)."""
    return _k2(spmv_stencil_pap, op, u, halo, out, partials, active)


spmv_stencil_pap.launches = 0


# --------------------------------------------------------------------- K7


def require_f64(dtype) -> None:
    """The dtype check of K7 and of backend ``pallas_dd``: float64 only."""
    if dtype != torch.float64:
        raise ValueError(f"pallas_dd is the float64 path (K7, the f64 instance of the stencil kernel); "
                         f"got {dtype}: use 'pallas' for float32")


def spmv_stencil_pap_dd(op: StencilOperator, u, halo=None, *, out=None, partials=None, active=None):
    """K7: (y = A u, per-block partials of u . y) in float64, the port of the
    TPU's double-float stencil (``spmv_padded_v2_dd_pap``); raises
    ValueError naming ``pallas_dd`` for any other dtype. Its plain version
    is K2's, ``spmv_stencil_pap_plain``."""
    require_f64(u.dtype)
    return _k2(spmv_stencil_pap_dd, op, u, halo, out, partials, active)


spmv_stencil_pap_dd.launches = 0


# --------------------------------------------------------------------- K3


def update_p_apply_plain(op, r, p, beta, halo=None, *, out_p=None, out_ap=None,
                         partials=None, active=None):
    """Plain torch K3: (p' = r + beta p, Ap' = A p', [p' . Ap'])."""
    out_p = torch.empty_like(r) if out_p is None else out_p
    out_ap = torch.empty_like(r) if out_ap is None else out_ap
    if partials is None:
        partials = torch.empty((1,), dtype=r.dtype, device=r.device)
    if _inactive(active):
        return out_p, out_ap, partials
    out_p.copy_(r + beta * p)
    below = above = None
    if halo is not None:
        below, above = halo[0] + beta * halo[2], halo[1] + beta * halo[3]
    out_ap.copy_(_apply_halo(op, out_p, below, above))
    partials.copy_(torch.dot(out_p.reshape(-1), out_ap.reshape(-1)).reshape(1))
    return out_p, out_ap, partials


def update_p_apply(op: StencilOperator, r, p, beta, halo=None, *, out_p=None, out_ap=None,
                   partials=None, active=None):
    """K3: (p' = r + beta p, Ap' = A p', per-block partials of p' . Ap').

    ``out_p`` must not alias ``p``: blocks read their neighbours' planes of p
    while others write p'."""
    grid = (op.nz, op.ny, op.nx)
    check_tensors(r, r=(r, grid, None), p=(p, grid, None), beta=(beta, (1,), None),
                  halo=(halo, (4, op.ny, op.nx), None), out_p=(out_p, grid, None),
                  out_ap=(out_ap, grid, None), active=(active, *_ACTIVE))
    _no_alias(out_p, r, p)
    _no_alias(out_ap, r, p)
    partials = _partials(op, r, partials)
    if r.device.type == "cpu":
        return update_p_apply_plain(op, r, p, beta, halo, out_p=out_p, out_ap=out_ap,
                                    partials=partials, active=active)
    out_p = torch.empty_like(r) if out_p is None else out_p
    out_ap = torch.empty_like(r) if out_ap is None else out_ap
    halo_r = None if halo is None else halo[0:2]
    halo_p = None if halo is None else halo[2:4]
    _launch(op, r, p, beta, halo_r, halo_p, out_p, out_ap, partials, active, True, True)
    update_p_apply.launches += 1
    return out_p, out_ap, partials


update_p_apply.launches = 0
