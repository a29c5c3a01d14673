"""SpMV dispatch (ref HPC_sparsemv.cpp:68-109; ``hpccg_tpu.ops.spmv``).

Backends:

- "auto" / "stencil" / "ell" / "dia": the operator's own plain torch matvec
  (``StencilOperator``, ``EllMatrix`` or ``DiaMatrix``), as the JAX package
  dispatches on the operator's type;
- "pallas": the CUDA stencil kernel (K1), the counterpart of the JAX
  package's Pallas stencil; on a CPU tensor its plain version. The explicit
  matrices' kernels (K9-K12) run on a layout built once per matrix
  (``ops/cuda/dia.py::prepare_dia``, ``ops/cuda/ell.py::prepare_ell``);
  ``solver.make_cg`` builds and holds it.
"""

from __future__ import annotations

import torch

from hpccg_tpu_torch.operators import DiaMatrix, EllMatrix, StencilOperator

OPERATORS = (StencilOperator, EllMatrix, DiaMatrix)


def spmv(A, x: torch.Tensor, *, backend: str = "auto") -> torch.Tensor:
    """y = A @ x."""
    if not isinstance(A, OPERATORS):
        raise TypeError(f"unknown operator type {type(A)}")
    if backend in ("auto", "stencil", "ell", "dia"):
        return A.matvec(x)
    if backend == "pallas" and isinstance(A, StencilOperator):
        from hpccg_tpu_torch.ops.cuda.stencil import spmv_stencil

        return spmv_stencil(A, A.grid(x)).reshape(-1)
    raise ValueError(f"unknown spmv backend {backend!r} for {type(A).__name__}")
