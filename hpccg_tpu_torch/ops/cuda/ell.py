"""ELL gather SpMV kernels K11 (float32, and its bfloat16-storage
instance) and K12 (float64) (``csrc/ell.cu``): the wrapper, its plain
version and its launch counter.

K11 replaces ``hpccg_tpu/ops/pallas/gell_kernel.py:_kernel`` and K12 its
``_kernel_dd``. The same kernel also computes what the wide-scatter tiers
compute: K13 (``gell_stack.py:_kernel_stack``, ``_kernel_stack_dd``) and
K14 (``gell_dynwin.py:_kernel_dynwin``, ``_kernel_dynwin_dd``). Those tiers,
and K11's chunk-scanning window, exist because the TPU has no hardware
gather; Hopper has one, so their host-side prep is not ported.

The kernel runs on a slot-major copy of the :class:`EllMatrix`,
``(width, n)`` values and int32 columns, which :func:`prepare_ell` builds
once per matrix (as the JAX package's ``prepare_gell`` does) and checks
(every column inside x). ``spmv_ell`` runs its plain version only for
tensors on the CPU; for CUDA tensors it launches the kernel (on the current
stream, without synchronising) or raises, and counts its launches per
instance: ``spmv_ell.launches_f32`` (K11), ``spmv_ell.launches_bf16``
(K11's bf16 instance) and ``spmv_ell.launches_f64`` (K12).

bfloat16: values, x and y in bf16, int32 columns, the sum in float32 in
slot order and y rounded once; the plain version sums the same float32
products in slot order (exact products, so a fused multiply-add on the
card gives the same bits), and the two agree bit for bit. The JAX
package's chooser never builds its gather kernel for 2-byte values
(``hpccg_tpu/reorder.py:257-259``); its bf16 ELL matvec is XLA's.
"""

from __future__ import annotations

import dataclasses

import torch

from hpccg_tpu_torch.operators import EllMatrix
from hpccg_tpu_torch.ops.cuda import STENCIL_DTYPES, check_tensors
from hpccg_tpu_torch.ops.cuda.build import check_launch, load_library


@dataclasses.dataclass(frozen=True)
class EllSlots:
    """Slot-major ELL, the kernel's layout: ``vals[s, i]`` / ``cols[s, i]``
    is slot s of row i; x has ``ncols`` entries."""

    vals: torch.Tensor  # (width, n)
    cols: torch.Tensor  # (width, n) int32
    ncols: int

    @property
    def width(self) -> int:
        return self.vals.shape[0]

    @property
    def local_nrow(self) -> int:
        return self.vals.shape[1]

    def matvec(self, x: torch.Tensor, *, out=None) -> torch.Tensor:
        return spmv_ell(self, x, out=out)


def prepare_ell(A: EllMatrix) -> EllSlots:
    """The slot-major copy of A on A's device. Columns are global, so x
    covers [0, total_nrow); a column outside it raises here, once, since the
    kernel does not check what it gathers."""
    ncols = A.total_nrow or A.local_nrow
    if A.cols.numel() and (int(A.cols.min()) < 0 or int(A.cols.max()) >= ncols):
        raise ValueError(f"an ELL column lies outside [0, {ncols})")
    return EllSlots(vals=A.vals.t().contiguous(), cols=A.cols.t().contiguous(), ncols=ncols)


def spmv_ell_plain(S: EllSlots, x: torch.Tensor, *, out=None) -> torch.Tensor:
    """Plain torch K11/K12: (vals * x[cols]) summed over the slots; for
    bfloat16, the float32 products summed in slot order, y rounded once."""
    if x.dtype == torch.bfloat16:
        xf = x.float()
        acc = torch.zeros((S.local_nrow,), dtype=torch.float32, device=x.device)
        for s in range(S.width):
            acc += S.vals[s].float() * xf.index_select(0, S.cols[s])
        y = acc.to(x.dtype)
    else:
        gathered = x.index_select(0, S.cols.reshape(-1)).view(S.cols.shape)
        y = (S.vals * gathered).sum(dim=0)
    return y if out is None else out.copy_(y)


def spmv_ell(S: EllSlots, x: torch.Tensor, *, out=None) -> torch.Tensor:
    """K11 (float32, bfloat16) / K12 (float64): y = A x (CUDA kernel; plain
    on the CPU)."""
    n = S.local_nrow
    check_tensors(x, STENCIL_DTYPES, x=(x, (S.ncols,), None), vals=(S.vals, (S.width, n), None),
                  cols=(S.cols, (S.width, n), torch.int32), out=(out, (n,), None))
    if x.device.type == "cpu":
        return spmv_ell_plain(S, x, out=out)
    if out is None:
        out = torch.empty((n,), dtype=x.dtype, device=x.device)
    if out.data_ptr() == x.data_ptr():
        raise ValueError("out must not alias x: rows gather from every part of x")
    lib = load_library()
    fn = {torch.float32: lib.hpccg_ell_f32, torch.float64: lib.hpccg_ell_f64, torch.bfloat16: lib.hpccg_ell_bf16}[
        x.dtype]
    # the C entry points launch on the current device, which must be the stream's
    with torch.cuda.device(x.device):
        err = fn(S.vals.data_ptr(), S.cols.data_ptr(), S.width, x.data_ptr(), out.data_ptr(), n,
                 torch.cuda.current_stream(x.device).cuda_stream)
    check_launch(err, "ELL kernel")
    attr = {torch.float32: "launches_f32", torch.float64: "launches_f64", torch.bfloat16: "launches_bf16"}[x.dtype]
    setattr(spmv_ell, attr, getattr(spmv_ell, attr) + 1)
    return out


spmv_ell.launches_f32 = 0  # K11 (and the wide-scatter classes of K13/K14)
spmv_ell.launches_bf16 = 0  # K11's bf16 instance
spmv_ell.launches_f64 = 0  # K12
