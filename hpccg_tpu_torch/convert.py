"""Carry the JAX package's state across, as numpy arrays.

The system has no weights: its state is the problem (b, x0, xexact on the
grid, or an explicit ELL / DIA matrix with them) and the CG result. The JAX
package's arrays, handed over with ``np.asarray``, become the port's tensors
bit for bit, so both packages can solve the very same system; the
``*_to_numpy`` functions go back.

bfloat16: numpy has no bf16 of its own; JAX hands over ``ml_dtypes``'
bfloat16. Such an array is widened exactly to float32 and narrowed again
by torch (``.to(torch.bfloat16)``), which gives back the same bits. Going
back, a bf16 tensor becomes an ``ml_dtypes`` bfloat16 array the same way
(``ml_dtypes`` is imported only then).

Sharded state: a JAX array sharded over a mesh is handed over as its global
numpy array (``np.asarray``); ``shards_from_numpy`` cuts it into the port's
per-rank tuple on a ``parallel.mesh.Mesh`` and ``shards_to_numpy`` joins the
tuple again. A distributed CGResult (x sharded) converts both ways with
``result_from_numpy(..., mesh=)`` and ``result_to_numpy``. An explicit
problem (a JAX ``DiaMatrix`` or ``EllMatrix`` with b, x0 and xexact)
becomes the port's with ``explicit_problem_from_numpy``, sharded over a
mesh when one is given (``parallel.cg.shard_problem``: per-rank row
blocks); ``explicit_problem_to_numpy`` joins the blocks again.
"""

from __future__ import annotations

import numpy as np
import torch

from hpccg_tpu_torch.config import Stencil
from hpccg_tpu_torch.models.stencil import Problem
from hpccg_tpu_torch.operators import DiaMatrix, DiaRows, EllMatrix, StencilOperator
from hpccg_tpu_torch.solver import CGResult


def _tensor(a, device, dtype=None) -> torch.Tensor:
    a = np.ascontiguousarray(np.asarray(a))
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    return t.to(device=device, dtype=dtype)


def _numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes

        return t.float().numpy().astype(ml_dtypes.bfloat16)
    return t.numpy()


def problem_from_numpy(nx, ny, nz, stencil, b, x0, xexact, *, device) -> Problem:
    """A Problem on ``device`` from the numpy vectors of a generated problem."""
    b = _tensor(b, device)
    if b.dtype not in (torch.float32, torch.float64, torch.bfloat16):
        raise TypeError(f"b must be float32, float64 or bfloat16, got {b.dtype}")
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
        "b": _numpy(prob.b),
        "x0": _numpy(prob.x0),
        "xexact": _numpy(prob.xexact),
    }


def shards_from_numpy(a, mesh) -> tuple:
    """A global flat numpy array (a sharded JAX array's ``np.asarray``) ->
    the port's per-rank shards on ``mesh``."""
    return mesh.shard(_tensor(a, "cpu"))


def shards_to_numpy(parts) -> np.ndarray:
    """Per-rank shards -> the global flat numpy array, in rank order."""
    return np.concatenate([_numpy(p).reshape(-1) for p in parts])


def result_from_numpy(x, niters, normr, rtrans, trace, *, device, mesh=None) -> CGResult:
    """A CGResult on ``device`` from numpy arrays (e.g. a JAX CGResult's).
    Each array keeps its own dtype: a bf16 solve has bf16 ``x`` and float32
    ``normr``, ``rtrans`` and ``trace``. With ``mesh``, x (global) is
    sharded over it, as a distributed solve returns it."""
    return CGResult(
        x=_tensor(x, device) if mesh is None else shards_from_numpy(x, mesh),
        niters=_tensor(niters, device, torch.int32),
        normr=_tensor(normr, device),
        rtrans=_tensor(rtrans, device),
        trace=_tensor(trace, device),
    )


def result_to_numpy(res: CGResult) -> dict:
    """The result's arrays; a sharded x (a distributed solve's) joined into
    the global array."""
    out = {name: _numpy(getattr(res, name)) for name in ("niters", "normr", "rtrans", "trace")}
    out["x"] = _numpy(res.x) if isinstance(res.x, torch.Tensor) else shards_to_numpy(res.x)
    return out


def ell_from_numpy(vals, cols, valid, start_row=0, total_nrow=None, *, device) -> EllMatrix:
    """An EllMatrix on ``device`` from the arrays of a JAX ``EllMatrix``."""
    return EllMatrix(vals=_tensor(vals, device), cols=_tensor(cols, device, torch.int32),
                     valid=_tensor(valid, device, torch.bool), start_row=int(start_row),
                     total_nrow=None if total_nrow is None else int(total_nrow))


def ell_to_numpy(A: EllMatrix) -> dict:
    return {"vals": _numpy(A.vals), "cols": _numpy(A.cols), "valid": _numpy(A.valid),
            "start_row": A.start_row, "total_nrow": A.total_nrow}


def dia_from_numpy(data, offsets, total_nrow=None, *, device) -> DiaMatrix:
    """A DiaMatrix on ``device`` from the arrays of a JAX ``DiaMatrix``."""
    return DiaMatrix(data=_tensor(data, device), offsets=tuple(int(o) for o in offsets),
                     total_nrow=None if total_nrow is None else int(total_nrow))


def dia_to_numpy(A: DiaMatrix) -> dict:
    return {"data": _numpy(A.data), "offsets": A.offsets, "total_nrow": A.total_nrow}


def explicit_problem_from_numpy(A: dict, b, x0, xexact, *, device, mesh=None, total_nnz=None) -> Problem:
    """A Problem on ``device`` from the numpy arrays of an explicit problem:
    ``A`` holds a DiaMatrix's ``data``/``offsets`` or an EllMatrix's
    ``vals``/``cols``/``valid`` (``dia_to_numpy`` / ``ell_to_numpy`` keys,
    with ``total_nrow``). With ``mesh`` the problem is sharded over it:
    the matrix as per-rank row blocks, the vectors as shards."""
    if "data" in A:
        M = dia_from_numpy(A["data"], A["offsets"], A.get("total_nrow"), device=device)
    else:
        M = ell_from_numpy(A["vals"], A["cols"], A["valid"], A.get("start_row", 0), A.get("total_nrow"),
                           device=device)
    n = M.local_nrow
    nnz = M.nnz if total_nnz is None else total_nnz
    prob = Problem(A=M, b=_tensor(b, device), x0=_tensor(x0, device), xexact=_tensor(xexact, device), total_nrow=n,
                   total_nnz_model=nnz, total_nnz_exact=nnz)
    if mesh is None:
        return prob
    from hpccg_tpu_torch.parallel.cg import shard_problem

    return shard_problem(prob, mesh)


def explicit_problem_to_numpy(prob: Problem) -> dict:
    """The problem's arrays, a sharded one's joined in rank order: ``A`` as
    ``dia_to_numpy`` / ``ell_to_numpy`` give it (of the assembled matrix),
    and b, x0, xexact."""
    A = prob.A
    if isinstance(A, tuple):
        if isinstance(A[0], DiaRows):
            A = DiaMatrix(data=torch.cat([blk.data.cpu() for blk in A], dim=1), offsets=A[0].offsets,
                          total_nrow=A[0].total_nrow)
        else:
            A = EllMatrix(vals=torch.cat([blk.vals.cpu() for blk in A]), cols=torch.cat([blk.cols.cpu() for blk in A]),
                          valid=torch.cat([blk.valid.cpu() for blk in A]), start_row=0, total_nrow=A[0].total_nrow)
    out = dia_to_numpy(A) if isinstance(A, DiaMatrix) else ell_to_numpy(A)
    vecs = {name: getattr(prob, name) for name in ("b", "x0", "xexact")}
    return {"A": out, **{k: _numpy(v) if isinstance(v, torch.Tensor) else shards_to_numpy(v) for k, v in vecs.items()}}
