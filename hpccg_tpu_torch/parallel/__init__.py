"""Distributed layer (the reference's MPI tier: make_local_matrix.cpp,
exchange_externals.cpp, the MPI collectives; ``hpccg_tpu.parallel``) on a
single-controller mesh.

- mesh.py: the 1-D z mesh, a list of devices with one shard per rank
- halo.py: the z-plane halo exchange and the halo'd stencil matvecs
- cg.py:   generate_problem_sharded and make_distributed_cg; distributed
  file mode: shard_problem and the dia-collective (K17), dia-halo, ell-halo
  and ell-allgather tiers
"""

from hpccg_tpu_torch.parallel.cg import (
    generate_problem_sharded,
    make_collective_dia_cg,
    make_distributed_cg,
    make_distributed_dia_cg,
    make_distributed_ell_cg,
    make_distributed_ell_halo_cg,
    shard_problem,
)
from hpccg_tpu_torch.parallel.halo import exchange_halo, stencil_matvec_halo
from hpccg_tpu_torch.parallel.mesh import Mesh, make_mesh, row_axis

__all__ = [
    "Mesh",
    "make_mesh",
    "row_axis",
    "exchange_halo",
    "stencil_matvec_halo",
    "generate_problem_sharded",
    "make_distributed_cg",
    "shard_problem",
    "make_distributed_dia_cg",
    "make_distributed_ell_cg",
    "make_distributed_ell_halo_cg",
    "make_collective_dia_cg",
]
