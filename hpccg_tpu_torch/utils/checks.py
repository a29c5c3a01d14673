"""Problem / solve validation (``hpccg_tpu.utils.checks``).

- validate_problem: construction invariants of a generated Problem
  (A @ xexact == b, symmetry on a sample, finite data);
- check_finite: fail-fast NaN/Inf detection on a solve result.
"""

from __future__ import annotations

import numpy as np
import torch


class ValidationError(AssertionError):
    pass


def _require(ok: bool, msg: str) -> None:
    if not ok:
        raise ValidationError(msg)


def validate_problem(prob, *, rtol: float = 1e-6) -> dict:
    """Check a Problem's construction invariants. Returns a findings dict;
    raises ValidationError on violation."""
    from hpccg_tpu_torch.ops.spmv import spmv

    A, b, xexact = prob.A, prob.b, prob.xexact
    n = prob.total_nrow
    _require(tuple(b.shape) == (n,), f"b shape {tuple(b.shape)} != ({n},)")
    _require(bool(torch.isfinite(b).all()), "b contains non-finite values")

    # b must equal A @ xexact (ref generate_matrix.cpp:284-286)
    err = float(torch.max(torch.abs(spmv(A, xexact) - b)))
    scale = float(torch.max(torch.abs(b))) or 1.0
    _require(err <= rtol * scale, f"A @ xexact != b (max err {err:.3g})")

    # symmetry on a random sample: u.(A v) == v.(A u), scaled by ||u||*||Av||
    rng = np.random.default_rng(0)
    u = torch.as_tensor(rng.standard_normal(n), dtype=b.dtype, device=b.device)
    v = torch.as_tensor(rng.standard_normal(n), dtype=b.dtype, device=b.device)
    av = spmv(A, v)
    uav = float(torch.dot(u, av))
    vau = float(torch.dot(v, spmv(A, u)))
    scale = float(torch.linalg.norm(u) * torch.linalg.norm(av)) or 1.0
    sym_err = abs(uav - vau) / scale
    sym_rtol = max(rtol, 100 * float(torch.finfo(b.dtype).eps))
    _require(sym_err <= sym_rtol, f"A not symmetric (rel err {sym_err:.3g})")

    return {"b_residual": err, "symmetry_rel_err": sym_err}


def check_finite(res) -> None:
    """Fail fast if a CGResult carries NaN/Inf (exact convergence under
    tolerance=0 yields alpha = 0/0, faithful to the reference recurrence).
    A distributed result's x is a tuple of shards."""
    normr = float(res.normr)
    if not np.isfinite(normr):
        raise ValidationError(
            f"solve diverged or over-converged: normr = {normr} after {int(res.niters)} iterations"
        )
    shards = (res.x,) if isinstance(res.x, torch.Tensor) else res.x
    if not all(bool(torch.isfinite(x).all()) for x in shards):
        raise ValidationError("solution vector contains non-finite values")
