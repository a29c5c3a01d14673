"""DIA SpMV kernels K9 (float32, and its bfloat16-storage instance) and K10
(float64) (``csrc/dia.cu``): the wrapper, its plain version and its launch
counter.

K9 replaces ``hpccg_tpu/ops/pallas/dia_kernel.py:_kernel``; K10, the same
kernel's float64 instance, replaces ``:_kernel_dd``, which carries f64 as
(hi, lo) float32 pairs because the TPU has no f64.

The kernel reads the :class:`DiaMatrix` as it is: ``data`` (ndiag, n) is
already diagonal-major, so the only layout built for it is the int32 offsets
on the card (:func:`prepare_dia`, once per matrix). A rank's row block
(:class:`DiaRows`, the dia-halo tier of ``parallel.cg``) runs the same
kernel on the rank's extended vector: row i reads x[i + bw_lo + off], x of
L + bw_lo + bw_hi entries (the window, ``PreparedDia.lo``/``hi``). ``spmv_dia`` runs its
plain version only for tensors on the CPU; for CUDA tensors it launches the
kernel (on the current stream, without synchronising) or raises, and counts
its launches per instance: ``spmv_dia.launches_f32`` (K9),
``spmv_dia.launches_bf16`` (K9's bf16 instance; those on a rank's window,
dia-halo's, in ``launches_bf16_window`` too) and ``spmv_dia.launches_f64``
(K10).

bfloat16: data, x and y in bf16, the sum in float32 (the products of two
bf16 values are exact there) and y rounded once; the plain version does the
same sums on float32 copies, so the two agree bit for bit. The JAX
package's K9 is float32 only; its bf16 DIA matvec is XLA's, in bf16
throughout (``DiaMatrix.matvec`` here).
"""

from __future__ import annotations

import dataclasses

import torch

from typing import Union

from hpccg_tpu_torch.operators import DiaMatrix, DiaRows
from hpccg_tpu_torch.ops.cuda import STENCIL_DTYPES, check_tensors
from hpccg_tpu_torch.ops.cuda.build import check_launch, load_library

MAX_DIAGS = 4096  # the structure chooser's cap; the kernel stages offsets in 1024-chunks


@dataclasses.dataclass(frozen=True)
class PreparedDia:
    """A DiaMatrix (or a rank's DiaRows) with its offsets as an int32 tensor
    on its device (the analog of the JAX package's ``prepare_dia``, without
    the block padding the TPU kernel needs). x has ``lo + n + hi`` entries
    and row i reads x[i + lo + off]: lo = hi = 0 for a DiaMatrix, its band
    for DiaRows."""

    A: Union[DiaMatrix, DiaRows]
    offsets: torch.Tensor  # (ndiag,) int32
    lo: int = 0
    hi: int = 0

    @property
    def xlen(self) -> int:
        return self.lo + self.A.local_nrow + self.hi

    def matvec(self, x: torch.Tensor, *, out=None) -> torch.Tensor:
        return spmv_dia(self, x, out=out)


def prepare_dia(A: Union[DiaMatrix, DiaRows]) -> PreparedDia:
    offs = list(A.offsets)
    if len(offs) != A.ndiag or any(b <= a for a, b in zip(offs, offs[1:])):
        raise ValueError("DiaMatrix offsets must be strictly increasing, one per row of data")
    if A.ndiag > MAX_DIAGS:
        raise ValueError(f"{A.ndiag} diagonals: the DIA kernel takes at most {MAX_DIAGS}")
    n = A.local_nrow
    lo, hi = (A.bw_lo, A.bw_hi) if isinstance(A, DiaRows) else (0, 0)
    if offs and (offs[0] <= -n - lo or offs[-1] >= n + hi):
        raise ValueError(f"offsets {offs[0]}..{offs[-1]} lie outside an {n}-row matrix")
    return PreparedDia(A=A, offsets=torch.tensor(offs, dtype=torch.int32, device=A.device), lo=lo, hi=hi)


def spmv_dia_plain(P: PreparedDia, x: torch.Tensor, *, out=None) -> torch.Tensor:
    """Plain torch K9/K10: one sliced multiply-add per diagonal
    (``DiaMatrix.matvec``, or ``DiaRows.matvec`` over the window); for
    bfloat16, on float32 copies of the data and x, y rounded once."""
    A = P.A
    if x.dtype == torch.bfloat16:
        y = dataclasses.replace(A, data=A.data.float()).matvec(x.float()).to(x.dtype)
    else:
        y = A.matvec(x)
    return y if out is None else out.copy_(y)


def spmv_dia(P: PreparedDia, x: torch.Tensor, *, out=None) -> torch.Tensor:
    """K9 (float32, bfloat16) / K10 (float64): y = A x (CUDA kernel; plain
    on the CPU)."""
    A = P.A
    n = A.local_nrow
    check_tensors(x, STENCIL_DTYPES, x=(x, (P.xlen,), None), data=(A.data, (A.ndiag, n), None),
                  offsets=(P.offsets, (A.ndiag,), torch.int32), out=(out, (n,), None))
    if x.device.type == "cpu":
        return spmv_dia_plain(P, x, out=out)
    if out is None:
        out = torch.empty((n,), dtype=x.dtype, device=x.device)
    if out.data_ptr() == x.data_ptr():
        raise ValueError("out must not alias x: rows read x at shifted positions")
    lib = load_library()
    fn = {torch.float32: lib.hpccg_dia_f32, torch.float64: lib.hpccg_dia_f64, torch.bfloat16: lib.hpccg_dia_bf16}[
        x.dtype]
    # the C entry points launch on the current device, which must be the stream's
    with torch.cuda.device(x.device):
        err = fn(A.data.data_ptr(), P.offsets.data_ptr(), A.ndiag, x.data_ptr(), out.data_ptr(), n, P.lo, P.xlen,
                 torch.cuda.current_stream(x.device).cuda_stream)
    check_launch(err, "DIA kernel")
    attr = {torch.float32: "launches_f32", torch.float64: "launches_f64", torch.bfloat16: "launches_bf16"}[x.dtype]
    setattr(spmv_dia, attr, getattr(spmv_dia, attr) + 1)
    if x.dtype == torch.bfloat16 and (P.lo or P.hi):
        spmv_dia.launches_bf16_window += 1
    return out


spmv_dia.launches_f32 = 0  # K9
spmv_dia.launches_bf16 = 0  # K9's bf16 instance
spmv_dia.launches_bf16_window = 0  # of them, on a rank's extended vector (the window instance)
spmv_dia.launches_f64 = 0  # K10
