"""The benchmark's inputs, made from ``--seed`` by one general generator
that reads a configuration and a traffic mix.

- The matrix: the 27-point stencil on the traffic's grid. A configuration
  of ``form`` ``operator`` hands the program the grid only (the reference's
  generated problem); one of ``form`` ``arrays`` hands it the ELL arrays a
  file would hold (values, int32 column ids, a validity mask), in the
  traffic's ``ordering``: ``natural`` (grid order) or ``random_symmetric``
  (rows and columns under one random permutation drawn from the seed).
- The right-hand sides: ``rhs`` of them, b_k = A x_k with the entries of
  x_k uniform in [x_low, x_high], resident on the device; x0 = 0.

The same seed gives the same inputs; every seed gives the same sizes.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from hpcbench import reference
from hpcbench.metrics import stencil27_nnz

DTYPES = {"float64": torch.float64, "float32": torch.float32}
OFFSETS = [(dz, dy, dx) for dz in (-1, 0, 1) for dy in (-1, 0, 1) for dx in (-1, 0, 1)]


@dataclasses.dataclass
class Problem:
    grid: Tuple[int, int, int]  # (nx, ny, nz)
    n: int
    nnz: int
    dtype: torch.dtype
    rhs: list  # b_k on the device
    x0: torch.Tensor
    ell: Optional[tuple] = None  # (vals, cols, valid) numpy arrays, form "arrays"


def torch_seed(seed: int) -> int:
    """A seed for torch.Generator (which takes 0 <= seed < 2**64) from any
    whole number."""
    return int(seed) % (1 << 64)


def stencil27_ell(nx: int, ny: int, nz: int, device) -> tuple:
    """(vals, cols, valid) of the 27-point matrix in grid order, on
    ``device``: each row's entries in the reference's order (z, then y,
    then x offset), 27 on the diagonal, -1 elsewhere, 0 and column 0 in
    the slots of neighbours outside the grid."""
    n = nx * ny * nz
    row = torch.arange(n, dtype=torch.int64, device=device)
    ix, iy, iz = row % nx, (row // nx) % ny, row // (nx * ny)
    off = torch.tensor(OFFSETS, dtype=torch.int64, device=device)
    dz, dy, dx = off[:, 0], off[:, 1], off[:, 2]
    jx, jy, jz = ix[:, None] + dx, iy[:, None] + dy, iz[:, None] + dz
    valid = (jx >= 0) & (jx < nx) & (jy >= 0) & (jy < ny) & (jz >= 0) & (jz < nz)
    cols = torch.where(valid, (jz * ny + jy) * nx + jx, 0)
    diag = (dz == 0) & (dy == 0) & (dx == 0)
    vals = torch.where(valid, torch.where(diag, 27.0, -1.0), 0.0).to(torch.float64)
    return vals, cols.to(torch.int32), valid


def permute_symmetric(vals, cols, valid, perm: torch.Tensor) -> tuple:
    """B = P A P^T: new row i is old row perm[i], old column j is new
    column inv[j]."""
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(perm.numel(), dtype=perm.dtype, device=perm.device)
    valid = valid[perm]
    cols = torch.where(valid, inv[cols[perm].long()], 0).to(torch.int32)
    return vals[perm], cols, valid


def make(config: dict, traffic: dict, seed: int, device) -> Problem:
    nx, ny, nz = (int(v) for v in traffic["grid"])
    n = nx * ny * nz
    if config.get("rows") is not None and int(config["rows"]) != n:
        raise ValueError(f"traffic grid {nx}x{ny}x{nz} has {n} rows; configuration {config['name']} states "
                         f"{config['rows']}")
    dtype = DTYPES[config["dtype"]]
    ordering = traffic.get("ordering", "natural")
    gen = torch.Generator(device=device).manual_seed(torch_seed(seed))
    ell = None
    if config["form"] == "arrays":
        vals, cols, valid = stencil27_ell(nx, ny, nz, device)
        if ordering == "random_symmetric":
            perm = torch.randperm(n, generator=gen, device=device)
            vals, cols, valid = permute_symmetric(vals, cols, valid, perm)
        elif ordering != "natural":
            raise ValueError(f"unknown ordering {ordering!r}")
        ell = (vals.to(dtype).cpu().numpy(), cols.cpu().numpy(), valid.cpu().numpy())
        del vals, cols, valid
    elif config["form"] != "operator":
        raise ValueError(f"unknown form {config['form']!r}")
    elif ordering != "natural":
        raise ValueError("a matrix-free operator takes the natural ordering only")
    problem = Problem(grid=(nx, ny, nz), n=n, nnz=stencil27_nnz(nx, ny, nz), dtype=dtype, rhs=[],
                      x0=torch.zeros(n, dtype=dtype, device=device), ell=ell)
    lo, hi = float(traffic["x_low"]), float(traffic["x_high"])
    xs = torch.rand((int(traffic["rhs"]), n), generator=gen, device=device, dtype=torch.float64)
    xs = xs * (hi - lo) + lo
    A = reference.matvec(config["reference"], problem, torch.float64, device)
    problem.rhs = [A(x).to(dtype) for x in xs]
    del A, xs
    return problem
