"""Runtime configuration (the reference's three config tiers, as in
``hpccg_tpu.config``).

The reference configures itself with compile-time -D flags, in-source
constants (use_7pt_stencil, generate_matrix.cpp:219; max_iter/tolerance,
main.cpp:187-188) and argv. Here everything is one runtime dataclass.
"""

from __future__ import annotations

import dataclasses
import enum

import torch


class Stencil(enum.Enum):
    """Stencil selection (ref generate_matrix.cpp:219,267)."""

    S27 = 27
    S7 = 7

    @classmethod
    def from_any(cls, v) -> "Stencil":
        if isinstance(v, Stencil):
            return v
        return cls(int(v))


# The stencil's diagonal / off-diagonal values (ref generate_matrix.cpp:270,273).
DIAG_VALUE = 27.0
OFFDIAG_VALUE = -1.0

# dtypes of the solve state. bf16 is storage only: reductions, the CG
# recurrence and the trace run in scalar_dtype (f32), as in the JAX package's
# whole-solve kernels (megakernel.py:133-138, :339-341)
SUPPORTED_DTYPES = (torch.float32, torch.float64, torch.bfloat16)


def scalar_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype of reductions and CG scalars for vectors of ``dtype``:
    float32 for 16-bit types, the dtype itself otherwise
    (``jnp.promote_types(dtype, jnp.float32)``, megakernel.py:341)."""
    return torch.float32 if dtype.itemsize == 2 else dtype


@dataclasses.dataclass(frozen=True)
class ProblemConfig:
    """A local problem block on an nx*ny*nz grid (z-stacked globally, ref
    generate_matrix.cpp:225-229)."""

    nx: int
    ny: int
    nz: int
    stencil: Stencil = Stencil.S27
    dtype: torch.dtype = torch.float64

    def __post_init__(self):
        object.__setattr__(self, "stencil", Stencil.from_any(self.stencil))
        if min(self.nx, self.ny, self.nz) < 1:
            raise ValueError(f"grid dims must be >= 1, got {(self.nx, self.ny, self.nz)}")
        if self.dtype not in SUPPORTED_DTYPES:
            raise ValueError(f"dtype must be one of {SUPPORTED_DTYPES}, got {self.dtype}")

    @property
    def local_nrow(self) -> int:
        return self.nx * self.ny * self.nz


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """CG solve parameters (ref main.cpp:187-188: max_iter=500, tolerance=0.0).

    Like the reference loop ``for k=1; k<max_iter && normr>tol`` the solver
    performs at most ``max_iter - 1`` iterations.
    """

    max_iter: int = 150
    tolerance: float = 0.0
