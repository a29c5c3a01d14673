"""Distributed layer (the reference's MPI tier: make_local_matrix.cpp,
exchange_externals.cpp, the MPI collectives; ``hpccg_tpu.parallel``) on a
single-controller mesh.

- mesh.py: the 1-D z mesh, a list of devices with one shard per rank
- halo.py: the z-plane halo exchange and the halo'd stencil matvecs
- cg.py:   generate_problem_sharded and make_distributed_cg
"""

from hpccg_tpu_torch.parallel.cg import generate_problem_sharded, make_distributed_cg
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
]
