"""The system under test, built the way a caller of ``hpccg_tpu_torch``
builds it. A configuration names its builder by the ``system`` key: the
module of that name in this folder has ``setup(config, problem, devices,
spans) -> Runner``. ``devices`` are the cell's, one per chip it asks for
(``run.cell_devices``); the inputs lie on the first. The port is imported
inside ``setup``, never at import time, so that importing it counts as
set-up."""

from __future__ import annotations

import dataclasses
import importlib
from typing import Callable, Optional

import torch


@dataclasses.dataclass
class Runner:
    """One caller's handle on the system: ``solve(k)`` solves right-hand
    side k from x0 and returns the program's result (``x``, ``niters``,
    ``normr``, ``trace``) in the basis it solves in; ``unshard`` (a
    sharded x -> one flat tensor on the first device) and then ``perm``
    (new row i is input row perm[i]) map that x back to the input's basis,
    after the window."""

    solve_fn: Callable
    rhs: list
    x0: object
    perm: Optional[torch.Tensor] = None
    notes: dict = dataclasses.field(default_factory=dict)
    unshard: Optional[Callable] = None

    def solve(self, k: int):
        return self.solve_fn(self.rhs[k], self.x0)

    def to_input_basis(self, x) -> torch.Tensor:
        if self.unshard is not None:
            x = self.unshard(x)
        if self.perm is None:
            return x
        out = torch.empty_like(x)
        out[self.perm] = x
        return out


def setup(name: str, config: dict, problem, devices, spans) -> Runner:
    if not name.isidentifier():
        raise ValueError(f"system name {name!r} is not a module name")
    return importlib.import_module(f"hpcbench.systems.{name}").setup(config, problem, devices, spans)
