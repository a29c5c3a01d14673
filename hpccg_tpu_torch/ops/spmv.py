"""SpMV dispatch (ref HPC_sparsemv.cpp:68-109; ``hpccg_tpu.ops.spmv``).

Backends for a :class:`StencilOperator`:

- "stencil" / "auto": the plain torch matvec (``StencilOperator.matvec``);
- "pallas": the CUDA stencil kernel (K1), the counterpart of the JAX
  package's Pallas stencil; on a CPU tensor its plain version.
"""

from __future__ import annotations

import torch

from hpccg_tpu_torch.operators import StencilOperator


def spmv(A, x: torch.Tensor, *, backend: str = "auto") -> torch.Tensor:
    """y = A @ x."""
    if not isinstance(A, StencilOperator):
        raise TypeError(f"unknown operator type {type(A)} (explicit matrices are not ported yet)")
    if backend in ("auto", "stencil"):
        return A.matvec(x)
    if backend == "pallas":
        from hpccg_tpu_torch.ops.cuda.stencil import spmv_stencil

        return spmv_stencil(A, A.grid(x)).reshape(-1)
    raise ValueError(f"unknown spmv backend {backend!r}")
