"""The generated problem's matrix, matrix-free: the 27-point stencil on an
nx x ny x nz grid (generate_matrix.cpp:251-276), 27 on the diagonal and -1
on every neighbour inside the grid, rows ordered iz*nx*ny + iy*nx + ix.

A x = 28 x - S(x), with S the sum over the 3x3x3 neighbourhood (self
included) of the zero-padded grid, taken one axis at a time.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def neighbour_sum(u: torch.Tensor) -> torch.Tensor:
    """S(u) of a (nz, ny, nx) grid: the 3x3x3 sum with zeros outside."""
    for dim in (2, 1, 0):
        pad = [0, 0, 0, 0, 0, 0]
        pad[2 * (2 - dim)] = pad[2 * (2 - dim) + 1] = 1
        w = F.pad(u, pad)
        n = u.shape[dim]
        u = w.narrow(dim, 0, n) + w.narrow(dim, 1, n) + w.narrow(dim, 2, n)
    return u


def matvec(problem, dtype, device):
    nx, ny, nz = problem.grid

    def apply(x: torch.Tensor) -> torch.Tensor:
        u = x.view(nz, ny, nx)
        return (28.0 * u - neighbour_sum(u)).reshape(-1)

    return apply
