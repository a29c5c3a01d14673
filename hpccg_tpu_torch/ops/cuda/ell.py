"""ELL gather SpMV kernels: K11 (float32, and its bfloat16-storage
instance) and K12 (float64) (``csrc/ell.cu``), which also compute K14, and
the relabelled wide-scatter kernel K13 (float32 and float64,
``csrc/ell_scatter.cu``): the wrapper, the plain versions, the layouts and
their chooser, and the launch counters.

K11 replaces ``hpccg_tpu/ops/pallas/gell_kernel.py:_kernel`` and K12 its
``_kernel_dd``; they also stand for the dynamic-window tier
``gell_dynwin.py:_kernel_dynwin`` (``_kernel_dynwin_dd``, K14), and K13's
kernel replaces the strip-stack tier ``gell_stack.py:_kernel_stack``
(``_kernel_stack_dd``). Those tiers bucket slots into strips or windows of
a VMEM-resident x because the TPU has no gather. Hopper gathers, but a
scattered 4-byte gather costs a 32-byte L2 sector, and the 32 lanes of a
warp share none on a scattered matrix; neither a cluster's distributed
shared memory nor per-SM windows of x with partial sums per window beat
L2 there (``scripts/scatter_probe.py``, ``scripts/ell_window.py``,
PERF.md). So K13's layout gives the gathers locality instead:
:class:`ScatterEll` holds the rows of a square matrix in reverse
Cuthill-McKee order and x relabelled the same way (each launch first
builds ``x'[j] = x[order[j]]``, then gathers from x' as K11 does on a banded
matrix and stores each row's sum at its row). Each row sums its slots in
K11's order: the results are K11's / K12's bits on the matrix as loaded.

:func:`prepare_ell` decides once per matrix: where
``reorder.relabel_order`` gives an order (a square float32/float64 matrix
whose rows gather widely and which RCM narrows; the rule and its
thresholds are the reorder module's, placed by sweeps on the card),
:class:`ScatterEll`; everything else, a random band and a rank's block
(``ncols != n``) included, :class:`EllSlots`, K11/K12's slot-major
``(width, n)`` copy. bfloat16 stays on K11's bf16 instance: the JAX
package's chooser never builds a gather tier for 2-byte values
(``hpccg_tpu/reorder.py:257-259``).

``spmv_ell`` runs the plain version of the layout it is given only for
tensors on the CPU; for CUDA tensors it launches the kernel (on the current
stream, without synchronising) or raises, and counts its launches per
instance: ``spmv_ell.launches_f32`` (K11), ``launches_bf16`` (K11's bf16
instance), ``launches_f64`` (K12), ``launches_scatter_f32`` and
``launches_scatter_f64`` (K13).

bfloat16: values, x and y in bf16, int32 columns, the sum in float32 in
slot order and y rounded once; the plain version sums the same float32
products in slot order (exact products, so a fused multiply-add on the
card gives the same bits), and the two agree bit for bit.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from hpccg_tpu_torch.operators import EllMatrix
from hpccg_tpu_torch.ops.cuda import KERNEL_DTYPES, STENCIL_DTYPES, check_tensors
from hpccg_tpu_torch.ops.cuda.build import check_launch, load_library
from hpccg_tpu_torch.reorder import relabel_order


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


@dataclasses.dataclass(frozen=True)
class ScatterEll:
    """K13's layout (``csrc/ell_scatter.cu``), slot-major like
    :class:`EllSlots`: ``vals[s, i]`` / ``cols[s, i]`` is slot s of row
    ``order[i]``, the row that work position i computes. The columns index
    x', x relabelled the same way, ``x'[j] = x[order[j]]``; x has ``ncols``
    (= n) entries."""

    vals: torch.Tensor  # (width, n)
    cols: torch.Tensor  # (width, n) int32, positions in x'
    order: torch.Tensor  # (n,) int32
    ncols: int

    @property
    def width(self) -> int:
        return self.vals.shape[0]

    @property
    def local_nrow(self) -> int:
        return self.vals.shape[1]

    def matvec(self, x: torch.Tensor, *, out=None) -> torch.Tensor:
        return spmv_ell(self, x, out=out)


def prepare_scatter(A: EllMatrix, perm) -> ScatterEll:
    """K13's layout of the square matrix A on A's device, its rows in the
    order ``perm`` (new position i computes row perm[i]; in the library,
    ``reorder.relabel_order``'s reverse Cuthill-McKee order) and x
    relabelled the same way."""
    ncols = _check_cols(A)
    n = A.local_nrow
    if A.start_row != 0 or ncols != n:
        raise ValueError("the relabelled layout needs the assembled square matrix")
    index = torch.as_tensor(np.ascontiguousarray(perm), dtype=torch.int64).to(A.device)
    inv = torch.empty_like(index)
    inv[index] = torch.arange(n, device=A.device)
    cols = inv[A.cols.long()][index].to(torch.int32)
    return ScatterEll(vals=A.vals[index].t().contiguous(), cols=cols.t().contiguous(), order=index.to(torch.int32),
                      ncols=ncols)


def prepare_ell(A: EllMatrix):
    """The kernel layout of A on A's device, chosen once per matrix:
    :class:`ScatterEll` (K13) where ``reorder.relabel_order`` gives A an
    order, else :class:`EllSlots` (K11/K12)."""
    perm = relabel_order(A)
    return ell_slots(A) if perm is None else prepare_scatter(A, perm)


def ell_slots(A: EllMatrix) -> EllSlots:
    """The slot-major copy of A on A's device (K11/K12's layout). Columns
    are global, so x covers [0, total_nrow); a column outside it raises
    here, once, since the kernel does not check what it gathers."""
    ncols = _check_cols(A)
    return EllSlots(vals=A.vals.t().contiguous(), cols=A.cols.t().contiguous(), ncols=ncols)


def _check_cols(A: EllMatrix) -> int:
    ncols = A.total_nrow or A.local_nrow
    if A.cols.numel() and (int(A.cols.min()) < 0 or int(A.cols.max()) >= ncols):
        raise ValueError(f"an ELL column lies outside [0, {ncols})")
    return ncols


def spmv_ell_plain(S, x: torch.Tensor, *, out=None) -> torch.Tensor:
    """Plain torch K11-K14: (vals * x[cols]) summed over the slots; for
    bfloat16, the float32 products summed in slot order, y rounded once.
    On a :class:`ScatterEll`, x relabelled first and each work position's
    sum stored at its row."""
    if isinstance(S, ScatterEll):
        xs = x.index_select(0, S.order)
        y = (S.vals * xs.index_select(0, S.cols.reshape(-1)).view(S.cols.shape)).sum(dim=0)
        y = torch.empty_like(y).index_copy_(0, S.order.long(), y)
    elif x.dtype == torch.bfloat16:
        xf = x.float()
        acc = torch.zeros((S.local_nrow,), dtype=torch.float32, device=x.device)
        for s in range(S.width):
            acc += S.vals[s].float() * xf.index_select(0, S.cols[s])
        y = acc.to(x.dtype)
    else:
        gathered = x.index_select(0, S.cols.reshape(-1)).view(S.cols.shape)
        y = (S.vals * gathered).sum(dim=0)
    return y if out is None else out.copy_(y)


def spmv_ell(S, x: torch.Tensor, *, out=None) -> torch.Tensor:
    """y = A x on A's layout from :func:`prepare_ell`: K11 (float32,
    bfloat16) / K12 (float64) on an :class:`EllSlots`, K13 on a
    :class:`ScatterEll` (CUDA kernels; plain on the CPU)."""
    n = S.local_nrow
    scatter = isinstance(S, ScatterEll)
    check_tensors(x, KERNEL_DTYPES if scatter else STENCIL_DTYPES, x=(x, (S.ncols,), None),
                  vals=(S.vals, (S.width, n), None), cols=(S.cols, (S.width, n), torch.int32),
                  out=(out, (n,), None))
    if scatter:
        check_tensors(x, KERNEL_DTYPES, order=(S.order, (n,), torch.int32))
    if x.device.type == "cpu":
        return spmv_ell_plain(S, x, out=out)
    if out is None:
        out = torch.empty((n,), dtype=x.dtype, device=x.device)
    if out.data_ptr() == x.data_ptr():
        raise ValueError("out must not alias x: rows gather from every part of x")
    lib = load_library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if scatter:
        fn = lib.hpccg_ell_scatter_f32 if x.dtype == torch.float32 else lib.hpccg_ell_scatter_f64
        x2 = torch.empty_like(x)
        with torch.cuda.device(x.device):
            err = fn(S.vals.data_ptr(), S.cols.data_ptr(), S.width, S.order.data_ptr(), x.data_ptr(), x2.data_ptr(),
                     out.data_ptr(), n, stream)
        check_launch(err, "wide-scatter ELL kernel")
        attr = "launches_scatter_f32" if x.dtype == torch.float32 else "launches_scatter_f64"
    else:
        fn = {torch.float32: lib.hpccg_ell_f32, torch.float64: lib.hpccg_ell_f64,
              torch.bfloat16: lib.hpccg_ell_bf16}[x.dtype]
        # the C entry points launch on the current device, which must be the stream's
        with torch.cuda.device(x.device):
            err = fn(S.vals.data_ptr(), S.cols.data_ptr(), S.width, x.data_ptr(), out.data_ptr(), n, stream)
        check_launch(err, "ELL kernel")
        attr = {torch.float32: "launches_f32", torch.float64: "launches_f64", torch.bfloat16: "launches_bf16"}[
            x.dtype]
    setattr(spmv_ell, attr, getattr(spmv_ell, attr) + 1)
    return out


spmv_ell.launches_f32 = 0  # K11
spmv_ell.launches_bf16 = 0  # K11's bf16 instance
spmv_ell.launches_f64 = 0  # K12
spmv_ell.launches_scatter_f32 = 0  # K13 (float32)
spmv_ell.launches_scatter_f64 = 0  # K13 (float64)
