"""hpccg_tpu_torch -- the PyTorch/CUDA port of hpccg_tpu for an NVIDIA H100.

The HPCCG mini-app's generated-stencil CG main path and its explicit-matrix
path (reference: Dart120/HPCCG-SYCL), ported from the JAX package
``hpccg_tpu``, which stays beside it as the reference:

- 27-point / 7-point stencil problem generation (ref generate_matrix.cpp)
- the implicit stencil operator A x = 28 x - S(x) in plain torch, and the
  explicit ELL and DIA matrices (``generate_ell``, HPC-row files through
  ``io``, the structure chooser with RCM in ``reorder``)
- the reference CG recurrence with the scalars kept on the device
  (ref HPCCG.cpp:312-402)
- hand-written Hopper (sm_90a) CUDA kernels for the Pallas kernels on that
  path: the stencil SpMV (with a fused p.Ap, its float64 instance, or with
  the p-update folded in), the fused x/r update with r.r, the scalar
  finalize step, the whole solve in one persistent cooperative kernel
  (backends megakernel and streamkernel), and the DIA and ELL gather SpMVs
  of the explicit matrices
- float64, float32 and bfloat16 state (bf16 vectors with float32
  reductions and scalars on the whole-solve backends)
- the YAML/JSON report (ref YAML_Doc, main.cpp)

Layout, as in ``hpccg_tpu``:
  models/     problem construction
  io.py       HPC-row files; reorder.py  RCM and the structure chooser
  ops/        vector ops, SpMV dispatch; ops/cuda the kernel wrappers
  csrc/       the CUDA sources, built with nvcc at first use on a GPU
  solver.py   CG solver and backends
  convert.py  the JAX package's state, carried across as numpy
  cli.py      command line and report
  utils/      timing, report, checks

The package imports torch and numpy, never jax.
"""

__version__ = "0.1.0"

from hpccg_tpu_torch.config import ProblemConfig, SolverConfig, Stencil
from hpccg_tpu_torch.models.stencil import generate_ell, generate_problem
from hpccg_tpu_torch.operators import DiaMatrix, EllMatrix, StencilOperator
from hpccg_tpu_torch.solver import CGResult, cg_solve, make_cg

__all__ = [
    "ProblemConfig",
    "SolverConfig",
    "Stencil",
    "StencilOperator",
    "EllMatrix",
    "DiaMatrix",
    "generate_problem",
    "generate_ell",
    "make_cg",
    "cg_solve",
    "CGResult",
    "__version__",
]
