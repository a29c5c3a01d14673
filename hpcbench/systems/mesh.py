"""The z-stacked problem on a mesh of the cell's devices, one rank each, as
the reference's MPI run lays it out (``mpirun -np N test_HPCCG nx ny nz``:
rank r owns global z-planes [r nz, (r+1) nz)): ``make_distributed_cg`` on
the global grid cut into equal z blocks, with the configuration's
``backend`` and ``method``; b and x0 sharded in set-up, x unsharded for
the sample after the window."""

from __future__ import annotations

from hpcbench.systems import Runner


def setup(config: dict, problem, devices, spans) -> Runner:
    from hpccg_tpu_torch.config import ProblemConfig
    from hpccg_tpu_torch.parallel.cg import make_distributed_cg
    from hpccg_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(devices=devices)
    nx, ny, nz = problem.grid
    if nz % mesh.size:
        raise ValueError(f"a grid of {nz} z-planes does not split into {mesh.size} equal ranks")
    local = ProblemConfig(nx, ny, nz // mesh.size, config["stencil"], problem.dtype)
    method = config.get("method", "cg")
    solve = make_distributed_cg(local, mesh, max_iter=config["max_iter"], tolerance=config["tolerance"],
                                backend=config["backend"], method=method)
    return Runner(solve, [mesh.shard(b) for b in problem.rhs], mesh.shard(problem.x0),
                  notes={"ranks": mesh.size, "backend": config["backend"], "method": method}, unshard=mesh.unshard)
