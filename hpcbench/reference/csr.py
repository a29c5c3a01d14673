"""An explicit matrix as the harness made it (the ELL arrays a file would
hold: values, column ids and a validity mask per row), multiplied as a
torch CSR matrix. Built from the harness's arrays, never from the program's
layouts."""

from __future__ import annotations

import numpy as np
import torch


def matvec(problem, dtype, device):
    vals, cols, valid = problem.ell
    counts = valid.sum(axis=1)
    crow = np.zeros(len(counts) + 1, dtype=np.int64)
    np.cumsum(counts, out=crow[1:])
    n = len(counts)
    A = torch.sparse_csr_tensor(
        torch.from_numpy(crow).to(device),
        torch.from_numpy(cols[valid].astype(np.int64)).to(device),
        torch.from_numpy(vals[valid]).to(device=device, dtype=dtype),
        size=(n, n),
    )

    def apply(x: torch.Tensor) -> torch.Tensor:
        return torch.mv(A, x)

    return apply
