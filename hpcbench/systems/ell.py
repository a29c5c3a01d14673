"""An explicit matrix handed over as the arrays a file holds, the way
``io.read_hpc_row_structured`` takes it: an ``EllMatrix`` on the host,
``reorder.auto_structure`` (DIA, or ELL in RCM order), b and x0 permuted
into the basis it chose, the operator moved to the first of the cell's
devices, and ``make_cg`` (which builds the kernel's layout once)."""

from __future__ import annotations

import numpy as np
import torch

from hpcbench.systems import Runner


def setup(config: dict, problem, devices, spans) -> Runner:
    from hpccg_tpu_torch.convert import ell_from_numpy
    from hpccg_tpu_torch.reorder import auto_structure
    from hpccg_tpu_torch.solver import make_cg

    vals, cols, valid = problem.ell
    A = ell_from_numpy(vals, cols, valid, device="cpu")
    with spans.span("reorder.structure"):
        op, perm, report = auto_structure(A)
    del A
    op = op.to(devices[0])
    rhs, x0, index = problem.rhs, problem.x0, None
    if perm is not None:
        index = torch.from_numpy(np.ascontiguousarray(perm, dtype=np.int64)).to(devices[0])
        rhs = [b[index] for b in rhs]
        x0 = x0[index]
    solve = make_cg(op, max_iter=config["max_iter"], tolerance=config["tolerance"], backend=config["backend"])
    return Runner(solve, rhs, x0, perm=index,
                  notes={"structure": report.format, "bandwidth": [report.bandwidth_before, report.bandwidth_after]})
