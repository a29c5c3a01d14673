"""Stencil SpMV kernels K1, K2, K3, K7 and the stencil CG update K4s
(``csrc/stencil.cu``): wrappers, plain versions and launch counters.

- K1 ``spmv_stencil``: y = A u (``stencil_v2.py:_kernel``; also the product
  of ``stencil_kernel.py:_kernel``, K8);
- K2 ``spmv_stencil_pap``: (y, partials of u . y) (``stencil_v2.py:_kernel_pap``);
- K3 ``update_p_apply``: (p' = r + beta p, Ap' = A p', partials of p'. Ap')
  (``fused_cg.py:_k1``); with ``store_ap=False`` it stores p' and the
  partials only, and K4s recomputes Ap';
- K4s ``update_x_r_stencil``: x += alpha p, r -= alpha A p in place, with
  partials of the new r . r: K4 (``fused_cg.py:_k2``) with A p recomputed
  from p, as ``streamkernel.py:_kernel`` recomputes it, in place of an Ap
  read back from device memory;
- K7 ``spmv_stencil_pap_dd``: K2's float64 instance, backend ``pallas_dd``
  (``stencil_v2.py:_kernel_dd`` / ``_kernel_dd_pap``, which carry f64 as
  (hi, lo) float32 pairs because the TPU has no f64; Hopper has native f64).

Vectors are contiguous (nz, ny, nx) tensors, the flat row-major layout of
the JAX package viewed as a grid, in float32, float64 or bfloat16 (K7:
float64 only). bf16 is storage: the kernels and the plain versions compute
in float32 and round to bf16 where they store (p' as it is formed, so Ap'
is A of the stored p'; y and Ap' when they are written), and the partials
sum the stored values; ``beta`` and the partials are then float32
(``config.scalar_dtype``). Halos are external z-planes for a shard,
(2, ny, nx) [below, above] for K1/K2 and (4, ny, nx) [r_below, r_above,
p_below, p_above] for K3; None is the domain boundary. ``beta`` is a
1-element device tensor; ``active`` an optional 1-element int32 tensor: at 0
nothing is written. ``partials`` are per-block sums that
``fused_cg.cg_finalize`` adds up; a plain version writes one partial.

Each wrapper runs its plain version only for tensors on the CPU. For CUDA
tensors it launches the kernel (on the current stream, without
synchronising) or raises; it counts its launches in ``<wrapper>.launches``
(bf16 ones in ``launches_bf16`` as well, and K3's launches without the Ap'
store in ``update_p_apply.launches_noap`` / ``launches_noap_bf16`` as well).
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from hpccg_tpu_torch.config import scalar_dtype
from hpccg_tpu_torch.operators import StencilOperator, apply_grid
from hpccg_tpu_torch.ops.cuda import STENCIL_DTYPES, check_tensors
from hpccg_tpu_torch.ops.cuda.build import check_launch, load_library
from hpccg_tpu_torch.ops.cuda.fused_cg import update_x_r_plain


def num_partials(op: StencilOperator, device, dtype=None) -> int:
    """How many partials K2/K3/K4s write on ``device`` for vectors of ``dtype``
    (default ``op.dtype``; 1 for the plain version): the kernel's tile is
    16 bytes a thread wide, so its grid depends on the element size."""
    if torch.device(device).type != "cuda":
        return 1
    return load_library().hpccg_stencil_num_blocks(op.nx, op.ny, op.nz, (dtype or op.dtype).itemsize)


@dataclasses.dataclass(frozen=True)
class TileGeometry:
    """The launch geometry of the stencil kernels on a grid: the tile (x
    points, y rows), the z-planes a block marches over, and the blocks."""

    tile_x: int
    tile_y: int
    z_chunk: int
    blocks: int


def tile_geometry(nx: int, ny: int, nz: int, dtype) -> TileGeometry:
    """K1-K3's geometry for an nx*ny*nz grid of ``dtype`` (needs the card:
    it asks the built library)."""
    out = (ctypes.c_int * 4)()
    load_library().hpccg_stencil_geometry(nx, ny, nz, dtype.itemsize, ctypes.addressof(out))
    return TileGeometry(*out)


def _partials(op, ref, partials):
    n, sdt = num_partials(op, ref.device, ref.dtype), scalar_dtype(ref.dtype)
    if partials is None:
        return torch.empty((n,), dtype=sdt, device=ref.device)
    check_tensors(ref, STENCIL_DTYPES, partials=(partials, (n,), sdt))
    return partials


def _inactive(active) -> bool:
    return active is not None and int(active.item()) == 0


def _apply_halo(op: StencilOperator, u: torch.Tensor, below, above) -> torch.Tensor:
    """A u on the grid, with external planes at z = -1 and z = nz, in the
    scalar dtype (float32 for bf16 u)."""
    sdt = scalar_dtype(u.dtype)
    if below is None:
        return apply_grid(u.to(sdt), op.stencil)
    ext = torch.cat([below.unsqueeze(0), u, above.unsqueeze(0)], 0).to(sdt)
    return apply_grid(ext, op.stencil)[1:-1]


def _dot(u, v) -> torch.Tensor:
    """[u . v] in the scalar dtype (a float32 sum of bf16 values)."""
    sdt = scalar_dtype(u.dtype)
    return torch.dot(u.reshape(-1).to(sdt), v.reshape(-1).to(sdt)).reshape(1)


def _no_alias(out, *inputs) -> None:
    if out is not None and any(out.data_ptr() == t.data_ptr() for t in inputs):
        raise ValueError("an output must not alias an input: blocks read neighbouring planes")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch(op, u, v, beta, halo_u, halo_v, out_p, out_y, partials, active, fuse_p, pap):
    lib = load_library()
    fn = {torch.float32: lib.hpccg_stencil_f32, torch.float64: lib.hpccg_stencil_f64,
          torch.bfloat16: lib.hpccg_stencil_bf16}[u.dtype]
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


def _count(wrapper, dtype) -> None:
    """One launch on ``wrapper.launches``, and on ``launches_bf16`` too for
    the bf16 instance."""
    wrapper.launches += 1
    if dtype == torch.bfloat16:
        wrapper.launches_bf16 += 1


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
    check_tensors(u, STENCIL_DTYPES, u=(u, grid, None), halo=(halo, (2, op.ny, op.nx), None),
                  out=(out, grid, None), active=(active, *_ACTIVE))
    _no_alias(out, u)
    if u.device.type == "cpu":
        return spmv_stencil_plain(op, u, halo, out=out, active=active)
    if out is None:
        out = torch.empty_like(u)
    _launch(op, u, None, None, halo, None, None, out, None, active, False, False)
    _count(spmv_stencil, u.dtype)
    return out


spmv_stencil.launches = spmv_stencil.launches_bf16 = 0


# --------------------------------------------------------------------- K2


def spmv_stencil_pap_plain(op, u, halo=None, *, out=None, partials=None, active=None):
    """Plain torch K2: (y = A u, [u . y])."""
    if out is None:
        out = torch.empty_like(u)
    if partials is None:
        partials = torch.empty((1,), dtype=scalar_dtype(u.dtype), device=u.device)
    if _inactive(active):
        return out, partials
    spmv_stencil_plain(op, u, halo, out=out)
    partials.copy_(_dot(u, out))
    return out, partials


def _k2(counter, op, u, halo, out, partials, active):
    """K2's checks and launch, shared with K7; a launch is counted in
    ``counter.launches``."""
    grid = (op.nz, op.ny, op.nx)
    check_tensors(u, STENCIL_DTYPES, u=(u, grid, None), halo=(halo, (2, op.ny, op.nx), None),
                  out=(out, grid, None), active=(active, *_ACTIVE))
    _no_alias(out, u)
    partials = _partials(op, u, partials)
    if u.device.type == "cpu":
        return spmv_stencil_pap_plain(op, u, halo, out=out, partials=partials, active=active)
    if out is None:
        out = torch.empty_like(u)
    _launch(op, u, None, None, halo, None, None, out, partials, active, False, True)
    _count(counter, u.dtype)
    return out, partials


def spmv_stencil_pap(op: StencilOperator, u, halo=None, *, out=None, partials=None, active=None):
    """K2: (y = A u, per-block partials of u . y)."""
    return _k2(spmv_stencil_pap, op, u, halo, out, partials, active)


spmv_stencil_pap.launches = spmv_stencil_pap.launches_bf16 = 0


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


spmv_stencil_pap_dd.launches = spmv_stencil_pap_dd.launches_bf16 = 0


# --------------------------------------------------------------------- K3


def update_p_apply_plain(op, r, p, beta, halo=None, *, out_p=None, out_ap=None,
                         partials=None, active=None, store_ap=True):
    """Plain torch K3: (p' = r + beta p, Ap' = A p', [p' . Ap']); Ap' is
    None when not ``store_ap``."""
    out_p = torch.empty_like(r) if out_p is None else out_p
    if out_ap is None and store_ap:
        out_ap = torch.empty_like(r)
    sdt = scalar_dtype(r.dtype)
    if partials is None:
        partials = torch.empty((1,), dtype=sdt, device=r.device)
    if _inactive(active):
        return out_p, out_ap, partials

    def xpby(a, b):  # a + beta b in the scalar dtype, stored in the vectors' dtype
        return (a.to(sdt) + beta * b.to(sdt)).to(r.dtype)

    out_p.copy_(xpby(r, p))
    below = above = None
    if halo is not None:
        below, above = xpby(halo[0], halo[2]), xpby(halo[1], halo[3])
    ap = _apply_halo(op, out_p, below, above).to(r.dtype)  # rounded as stored
    partials.copy_(_dot(out_p, ap))
    if out_ap is not None:
        out_ap.copy_(ap)
    return out_p, out_ap, partials


def update_p_apply(op: StencilOperator, r, p, beta, halo=None, *, out_p=None, out_ap=None,
                   partials=None, active=None, store_ap=True):
    """K3: (p' = r + beta p, Ap' = A p', per-block partials of p' . Ap').
    With ``store_ap=False`` Ap' is not stored (``out_ap`` must be None and
    None is returned in its place); the partials still sum p' . Ap' over
    Ap' rounded as it would be stored.

    ``out_p`` must not alias ``p``: blocks read their neighbours' planes of p
    while others write p'."""
    if not store_ap and out_ap is not None:
        raise ValueError("out_ap given with store_ap=False")
    grid = (op.nz, op.ny, op.nx)
    check_tensors(r, STENCIL_DTYPES, r=(r, grid, None), p=(p, grid, None),
                  beta=(beta, (1,), scalar_dtype(r.dtype)), halo=(halo, (4, op.ny, op.nx), None),
                  out_p=(out_p, grid, None), out_ap=(out_ap, grid, None), active=(active, *_ACTIVE))
    _no_alias(out_p, r, p)
    _no_alias(out_ap, r, p)
    partials = _partials(op, r, partials)
    if r.device.type == "cpu":
        return update_p_apply_plain(op, r, p, beta, halo, out_p=out_p, out_ap=out_ap,
                                    partials=partials, active=active, store_ap=store_ap)
    out_p = torch.empty_like(r) if out_p is None else out_p
    if out_ap is None and store_ap:
        out_ap = torch.empty_like(r)
    halo_r = None if halo is None else halo[0:2]
    halo_p = None if halo is None else halo[2:4]
    _launch(op, r, p, beta, halo_r, halo_p, out_p, out_ap, partials, active, True, True)
    _count(update_p_apply, r.dtype)
    if not store_ap:
        update_p_apply.launches_noap += 1
        if r.dtype == torch.bfloat16:
            update_p_apply.launches_noap_bf16 += 1
    return out_p, out_ap, partials


update_p_apply.launches = update_p_apply.launches_bf16 = 0
# of them, without the Ap' store (one device's pallas_fused path)
update_p_apply.launches_noap = update_p_apply.launches_noap_bf16 = 0


# -------------------------------------------------------------------- K4s


def update_x_r_stencil_plain(op, x, r, p, alpha, *, partials=None, active=None):
    """Plain torch K4s: K4's plain update (``fused_cg.update_x_r_plain``)
    with Ap = A p rounded to the vectors' dtype, as K3 stores it."""
    # inactive: nothing is written, and A p is not computed
    ap = p if _inactive(active) else _apply_halo(op, p, None, None).to(p.dtype)
    return update_x_r_plain(x, r, p, ap, alpha, partials=partials, active=active)


def update_x_r_stencil(op: StencilOperator, x, r, p, alpha, *, partials=None, active=None):
    """K4s: x += alpha p and r -= alpha A p in place, on the (nz, ny, nx)
    grid of one device (no halo planes), with per-block partials of the new
    r . r (as many as K3 writes). Returns (x, r, partials).

    ``x`` and ``r`` must not alias ``p``: blocks read their neighbours'
    planes of p while others write x and r."""
    grid = (op.nz, op.ny, op.nx)
    check_tensors(x, STENCIL_DTYPES, x=(x, grid, None), r=(r, grid, None), p=(p, grid, None),
                  alpha=(alpha, (1,), scalar_dtype(x.dtype)), active=(active, *_ACTIVE))
    _no_alias(x, p)
    _no_alias(r, p)
    partials = _partials(op, x, partials)
    if x.device.type == "cpu":
        return update_x_r_stencil_plain(op, x, r, p, alpha, partials=partials, active=active)
    lib = load_library()
    fn = {torch.float32: lib.hpccg_stencil_update_f32, torch.float64: lib.hpccg_stencil_update_f64,
          torch.bfloat16: lib.hpccg_stencil_update_bf16}[x.dtype]
    # the C entry points launch on the current device, which must be the stream's
    with torch.cuda.device(x.device):
        err = fn(_ptr(x), _ptr(r), _ptr(p), _ptr(alpha), _ptr(partials), _ptr(active), op.nx, op.ny, op.nz,
                 op.stencil.value, torch.cuda.current_stream(x.device).cuda_stream)
    check_launch(err, "stencil update kernel")
    _count(update_x_r_stencil, x.dtype)
    return x, r, partials


update_x_r_stencil.launches = update_x_r_stencil.launches_bf16 = 0
