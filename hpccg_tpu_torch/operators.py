"""The implicit stencil operator, in plain torch (``hpccg_tpu.operators``).

For the generated problem every diagonal is 27 and every off-diagonal -1
(generate_matrix.cpp:268-274), so A @ x = 28*x - S(x), where S is the
boundary-clipped neighbour sum including self. The matrix never
materialises. This plain torch matvec is the port's own reference: the CPU
path, and what the CUDA stencil kernel is held against on the card.

Vectors are flat (n,) tensors ordered row-major over (iz, iy, ix), the
reference's ``currow = iz*nx*ny + iy*nx + ix`` (generate_matrix.cpp:254), so
``x.view(nz, ny, nx)`` is free and exact.
"""

from __future__ import annotations

import dataclasses

import torch

from hpccg_tpu_torch.config import DIAG_VALUE, OFFDIAG_VALUE, Stencil


def stencil_offsets(stencil: Stencil):
    """(sz, sy, sx) offset triples in the reference's enumeration order
    (generate_matrix.cpp:259-261: sz outer, sy middle, sx inner)."""
    offs = [(sz, sy, sx) for sz in (-1, 0, 1) for sy in (-1, 0, 1) for sx in (-1, 0, 1)]
    if stencil == Stencil.S7:
        # ref generate_matrix.cpp:267 -- keep sz^2+sy^2+sx^2 <= 1
        offs = [o for o in offs if o[0] ** 2 + o[1] ** 2 + o[2] ** 2 <= 1]
    return offs


def _axis_sum3(u: torch.Tensor, dim: int) -> torch.Tensor:
    """v[i] = (u[i-1] + u[i]) + u[i+1] along ``dim``, zero beyond the ends.

    Same association as the JAX package's ``_axis_sum3``, so the f64 sums
    agree bit for bit."""
    n = u.shape[dim]
    s = u.clone()
    if n > 1:
        s.narrow(dim, 1, n - 1).add_(u.narrow(dim, 0, n - 1))
        s.narrow(dim, 0, n - 1).add_(u.narrow(dim, 1, n - 1))
    return s


def neighbor_sum_27(u: torch.Tensor) -> torch.Tensor:
    """Sum of u over the 3x3x3 neighbourhood (incl. self) of a (nz, ny, nx)
    grid, zero-clipped; separable: x, then y, then z."""
    return _axis_sum3(_axis_sum3(_axis_sum3(u, 2), 1), 0)


def neighbor_sum_7(u: torch.Tensor) -> torch.Tensor:
    """Sum of u over self + 6 face neighbours, zero beyond the boundaries."""
    s = u
    for dim in range(3):
        s = s + _axis_sum3(u, dim) - u
    return s


def neighbor_sum(u: torch.Tensor, stencil: Stencil) -> torch.Tensor:
    return neighbor_sum_27(u) if stencil == Stencil.S27 else neighbor_sum_7(u)


def apply_grid(u: torch.Tensor, stencil: Stencil) -> torch.Tensor:
    """A @ u on a (nz, ny, nx) grid: (DIAG - OFFDIAG)*u + OFFDIAG*S(u)."""
    s = neighbor_sum(u, stencil)
    return (DIAG_VALUE - OFFDIAG_VALUE) * u + OFFDIAG_VALUE * s


def _clip_counts(n: int):
    return [min(i + 1, 2) + min(n - i, 2) - 1 for i in range(n)]


@dataclasses.dataclass(frozen=True)
class StencilOperator:
    """Implicit A for the generated problem on an nx*ny*nz grid.

    Metadata only: the operator owns no tensors. ``nz`` is the local z-extent
    when used as one shard of a z-stacked global domain.
    """

    nx: int
    ny: int
    nz: int
    stencil: Stencil = Stencil.S27
    dtype: torch.dtype = torch.float64

    @property
    def local_nrow(self) -> int:
        return self.nx * self.ny * self.nz

    def grid(self, x: torch.Tensor) -> torch.Tensor:
        return x.view(self.nz, self.ny, self.nx)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """A @ x = 28*x - S(x); clipped neighbours contribute 0 to S, matching
        the reference's validity test (generate_matrix.cpp:266)."""
        return apply_grid(self.grid(x), self.stencil).reshape(-1)

    @property
    def nnz(self) -> int:
        """Exact local nonzero count (boundary-clipped)."""
        cx, cy, cz = (_clip_counts(n) for n in (self.nx, self.ny, self.nz))
        if self.stencil == Stencil.S27:
            return sum(cx) * sum(cy) * sum(cz)
        # 7-pt: self + up to 2 per axis
        ex, ey, ez = (sum(c - 1 for c in cs) for cs in (cx, cy, cz))
        return (
            self.local_nrow
            + ex * self.ny * self.nz
            + ey * self.nx * self.nz
            + ez * self.nx * self.ny
        )

    @property
    def nnz_model(self) -> int:
        """The reference's approximate count: stencil_size * nrow
        (generate_matrix.cpp:223,226 uses 27*nrow regardless of boundary)."""
        return self.stencil.value * self.local_nrow
