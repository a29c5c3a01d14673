"""Carry the JAX package's state across, as numpy arrays.

The system has no weights: its state is the problem (b, x0, xexact on the
grid) and the CG result. The JAX package's arrays, handed over with
``np.asarray``, become the port's tensors bit for bit, so both packages can
solve the very same system; the ``*_to_numpy`` functions go back.
"""

from __future__ import annotations

import numpy as np
import torch

from hpccg_tpu_torch.config import Stencil
from hpccg_tpu_torch.models.stencil import Problem
from hpccg_tpu_torch.operators import StencilOperator
from hpccg_tpu_torch.solver import CGResult


def _tensor(a, device, dtype=None) -> torch.Tensor:
    a = np.ascontiguousarray(np.asarray(a))
    return torch.from_numpy(a.copy()).to(device=device, dtype=dtype)


def problem_from_numpy(nx, ny, nz, stencil, b, x0, xexact, *, device) -> Problem:
    """A Problem on ``device`` from the numpy vectors of a generated problem."""
    b = _tensor(b, device)
    if b.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"b must be float32 or float64, got {b.dtype}")
    op = StencilOperator(nx=nx, ny=ny, nz=nz, stencil=Stencil.from_any(stencil), dtype=b.dtype)
    if tuple(b.shape) != (op.local_nrow,):
        raise ValueError(f"b has shape {tuple(b.shape)}, expected ({op.local_nrow},)")
    return Problem(
        A=op,
        b=b,
        x0=_tensor(x0, device, b.dtype),
        xexact=_tensor(xexact, device, b.dtype),
        total_nrow=op.local_nrow,
        total_nnz_model=op.nnz_model,
        total_nnz_exact=op.nnz,
    )


def problem_to_numpy(prob: Problem) -> dict:
    A = prob.A
    return {
        "nx": A.nx,
        "ny": A.ny,
        "nz": A.nz,
        "stencil": A.stencil.value,
        "b": prob.b.cpu().numpy(),
        "x0": prob.x0.cpu().numpy(),
        "xexact": prob.xexact.cpu().numpy(),
    }


def result_from_numpy(x, niters, normr, rtrans, trace, *, device) -> CGResult:
    """A CGResult on ``device`` from numpy arrays (e.g. a JAX CGResult's)."""
    x = _tensor(x, device)
    return CGResult(
        x=x,
        niters=_tensor(niters, device, torch.int32),
        normr=_tensor(normr, device, x.dtype),
        rtrans=_tensor(rtrans, device, x.dtype),
        trace=_tensor(trace, device, x.dtype),
    )


def result_to_numpy(res: CGResult) -> dict:
    return {
        "x": res.x.cpu().numpy(),
        "niters": res.niters.cpu().numpy(),
        "normr": res.normr.cpu().numpy(),
        "rtrans": res.rtrans.cpu().numpy(),
        "trace": res.trace.cpu().numpy(),
    }
