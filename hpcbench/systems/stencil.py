"""The generated problem, matrix-free: ``StencilOperator`` and ``make_cg``
(``python -m hpccg_tpu_torch nx ny nz`` without the report), on the first
of the cell's devices."""

from __future__ import annotations

from hpcbench.systems import Runner


def setup(config: dict, problem, devices, spans) -> Runner:
    from hpccg_tpu_torch.config import Stencil
    from hpccg_tpu_torch.operators import StencilOperator
    from hpccg_tpu_torch.solver import make_cg, resolve_backend

    nx, ny, nz = problem.grid
    op = StencilOperator(nx, ny, nz, Stencil.from_any(config["stencil"]), problem.dtype)
    solve = make_cg(op, max_iter=config["max_iter"], tolerance=config["tolerance"], backend=config["backend"])
    backend = resolve_backend(config["backend"], devices[0], problem.dtype)
    return Runner(solve, problem.rhs, problem.x0, notes={"backend": backend})
