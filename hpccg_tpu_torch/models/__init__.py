"""Problem construction."""

from hpccg_tpu_torch.models.stencil import Problem, generate_ell, generate_problem

__all__ = ["Problem", "generate_ell", "generate_problem"]
