"""27-pt / 7-pt stencil problem generator (ref generate_matrix.cpp:196-307;
``hpccg_tpu.models.stencil``).

The implicit operator materialises nothing; b, x0 and xexact are built on
the device:

- b = A @ ones, i.e. b[i] = 27 - (nnz_in_row[i] - 1) (:285), small integers,
  exact in any float dtype;
- xexact = 1 (:286); x0 = 0 (:284).

``generate_ell`` builds the same matrix explicitly, as a padded ELL with the
reference's z-stacked partition metadata (:225-229, :298-304): rank r of
``size`` owns global rows [n*r, n*(r+1)), and rows are clipped in x/y by
coordinate and in z by the global row range (:266). It is vectorised on the
target device: iota -> coordinates -> the 27 (7) candidate columns and their
validity.
"""

from __future__ import annotations

import dataclasses
from typing import Union

import torch

from hpccg_tpu_torch.config import DIAG_VALUE, OFFDIAG_VALUE, ProblemConfig
from hpccg_tpu_torch.operators import DiaMatrix, EllMatrix, StencilOperator, stencil_offsets


@dataclasses.dataclass(frozen=True)
class Problem:
    """A generated CG problem: A, b, x0, xexact + global metadata."""

    A: Union[StencilOperator, EllMatrix, DiaMatrix]
    b: torch.Tensor
    x0: torch.Tensor
    xexact: torch.Tensor
    total_nrow: int
    total_nnz_model: int  # reference's approximate 27*total_nrow (main.cpp:226)
    total_nnz_exact: int

    @property
    def local_nrow(self) -> int:
        return self.b.shape[0]


def generate_problem(cfg: ProblemConfig, device) -> Problem:
    """Single-domain problem with the implicit stencil operator, built on
    ``device``."""
    op = StencilOperator(nx=cfg.nx, ny=cfg.ny, nz=cfg.nz, stencil=cfg.stencil, dtype=cfg.dtype)
    n = op.local_nrow
    xexact = torch.ones((n,), dtype=cfg.dtype, device=device)
    b = op.matvec(xexact)
    x0 = torch.zeros((n,), dtype=cfg.dtype, device=device)
    return Problem(
        A=op,
        b=b,
        x0=x0,
        xexact=xexact,
        total_nrow=n,
        total_nnz_model=op.nnz_model,
        total_nnz_exact=op.nnz,
    )


def _ell_arrays(cfg: ProblemConfig, start_row: int, total_nrow: int, device):
    """(vals, cols, valid) of rows [start_row, start_row + n) on ``device``."""
    nx, ny = cfg.nx, cfg.ny
    n = cfg.local_nrow
    if total_nrow > 2**31:
        # cols are int32: a larger explicit matrix would wrap silently (the
        # implicit StencilOperator has no such limit)
        raise ValueError(f"explicit ELL construction supports < 2^31 global rows (got {total_nrow}); "
                         "use the implicit StencilOperator instead")
    off = torch.tensor(stencil_offsets(cfg.stencil), dtype=torch.int64, device=device)  # (width, 3)
    dcol = off[:, 0] * (nx * ny) + off[:, 1] * nx + off[:, 2]
    lrow = torch.arange(n, dtype=torch.int64, device=device)[:, None]
    ix, iy = lrow % nx, (lrow // nx) % ny
    grow = lrow + start_row
    cols = grow + dcol[None, :]
    sx, sy = off[:, 2][None, :], off[:, 1][None, :]
    valid = (
        (ix + sx >= 0) & (ix + sx < nx) & (iy + sy >= 0) & (iy + sy < ny) & (cols >= 0) & (cols < total_nrow)
    )
    vals = torch.where(cols == grow, DIAG_VALUE, OFFDIAG_VALUE).to(cfg.dtype)
    vals = torch.where(valid, vals, torch.zeros((), dtype=cfg.dtype, device=device))
    cols = torch.where(valid, cols, 0).to(torch.int32)
    return vals, cols, valid


def generate_ell(cfg: ProblemConfig, device, rank: int = 0, size: int = 1) -> Problem:
    """Explicit padded-ELL problem: rank's shard of the z-stacked domain of
    ``size`` ranks (the general path's matrix; ``hpccg_tpu.generate_ell``).
    b = A @ ones: the diagonal contributes 27 and each of the (nnz_row - 1)
    off-diagonals -1 (generate_matrix.cpp:285)."""
    n = cfg.local_nrow
    total_nrow = n * size
    start_row = n * rank
    vals, cols, valid = _ell_arrays(cfg, start_row, total_nrow, device)
    A = EllMatrix(vals=vals, cols=cols, valid=valid, start_row=start_row, total_nrow=total_nrow)
    nnz_row = valid.sum(dim=1).to(cfg.dtype)
    b = DIAG_VALUE + OFFDIAG_VALUE * (nnz_row - 1.0)
    # exact global count: the z-stacked global grid's clipped stencil
    whole = StencilOperator(nx=cfg.nx, ny=cfg.ny, nz=cfg.nz * size, stencil=cfg.stencil, dtype=cfg.dtype)
    return Problem(
        A=A,
        b=b,
        x0=torch.zeros((n,), dtype=cfg.dtype, device=device),
        xexact=torch.ones((n,), dtype=cfg.dtype, device=device),
        total_nrow=total_nrow,
        total_nnz_model=cfg.stencil.value * total_nrow,
        total_nnz_exact=whole.nnz,
    )
