"""27-pt / 7-pt stencil problem generator (ref generate_matrix.cpp:196-307;
``hpccg_tpu.models.stencil``).

The implicit operator materialises nothing; b, x0 and xexact are built on
the device:

- b = A @ ones, i.e. b[i] = 27 - (nnz_in_row[i] - 1) (:285), small integers,
  exact in any float dtype;
- xexact = 1 (:286); x0 = 0 (:284).

``generate_ell`` (the explicit matrix) waits for the explicit-matrix slice.
"""

from __future__ import annotations

import dataclasses

import torch

from hpccg_tpu_torch.config import ProblemConfig
from hpccg_tpu_torch.operators import StencilOperator


@dataclasses.dataclass(frozen=True)
class Problem:
    """A generated CG problem: A, b, x0, xexact + global metadata."""

    A: StencilOperator
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
