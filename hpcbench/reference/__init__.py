"""The benchmark's plain reference: the HPCCG recurrence and its matvecs in
plain torch, written apart from the program under test.

Nothing here imports the program (``hpccg_tpu_torch``) or the JAX package,
and nothing here reads what the program derived: the matvecs are built from
the inputs the harness made (the grid, or the ELL arrays a file would hold).
A configuration names its matvec by the ``reference`` key; the module of
that name in this folder has ``matvec(problem, dtype, device)``.
"""

from __future__ import annotations

import importlib


def matvec(name: str, problem, dtype, device):
    """The reference matvec ``name`` (a module of this folder) for the
    harness's ``problem`` (``hpcbench.inputs.Problem``)."""
    if not name.isidentifier():
        raise ValueError(f"reference matvec name {name!r} is not a module name")
    return importlib.import_module(f"hpcbench.reference.{name}").matvec(problem, dtype, device)
