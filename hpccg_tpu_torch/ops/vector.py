"""Vector ops: ddot, waxpby, compute_residual (ref ddot.cpp:60-73,
waxpby.cpp:69-93, compute_residual.cpp:62-67; ``hpccg_tpu.ops.vector``).

Plain torch. Each returns a device tensor; nothing is read back to the host.
"""

from __future__ import annotations

import torch


def ddot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x . y as a 0-dim tensor on the vectors' device (ref ddot.cpp)."""
    return torch.dot(x, y)


def waxpby(alpha, x: torch.Tensor, beta, y: torch.Tensor) -> torch.Tensor:
    """w = alpha*x + beta*y (ref waxpby.cpp:54-93)."""
    return alpha * x + beta * y


def compute_residual(v1: torch.Tensor, v2: torch.Tensor) -> torch.Tensor:
    """max_i |v1 - v2| (ref compute_residual.cpp:59-81)."""
    return torch.max(torch.abs(v1 - v2))
