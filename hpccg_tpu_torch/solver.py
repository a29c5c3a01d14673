"""Conjugate-gradient solver (ref HPCCG.cpp:312-402; ``hpccg_tpu.solver``).

The reference iteration, replicated exactly:

    p = x0; Ap = A@p; r = b - Ap; rtrans = r.r; normr = sqrt(rtrans)
    for k = 1 .. max_iter-1 while normr > tolerance:
        if k == 1: p = r
        else:      beta = rtrans_new/rtrans_old; p = r + beta*p
        normr = sqrt(rtrans)                     (the printed residual)
        Ap = A@p; alpha = rtrans / (p . Ap)
        x += alpha*p; r -= alpha*Ap

The scalars (alpha, beta, rtrans, normr, the trace, k and the exit flag)
stay on the device in :class:`CGScalars` and advance in ``cg_finalize``:
one single-block kernel on CUDA, predicated torch ops in its plain version.
The host launches iterations and reads the ``active`` flag once every
``check_every`` iterations (16 on CUDA, 1 on the CPU) to stop launching;
every kernel launched after the exit reads ``active == 0`` and writes
nothing, and the finalize step zeroes alpha and beta at the exit, so the
plain-torch axpys of the ``pallas`` backend are no-ops too. The result is
that of the JAX package's ``while_loop``.

Backends (the JAX package's names, so ``--backend`` means the same):

- ``stencil``: plain torch throughout, the finalize step included. The CPU
  path and the card's plain baseline.
- ``pallas``: p = r + beta p in torch, K2 (Ap and the p.Ap partials), then
  x += alpha p, r -= alpha Ap and r.r in torch (JAX ``solver.py:619-646``).
- ``pallas_fused``: K3 (p', Ap', p'.Ap') then K4 (x', r', r'.r') (JAX
  ``solver.py:314-367``).
- ``pallas_dd``: the ``pallas`` path in float64 only, with K7 (K2's native
  f64 instance) in place of K2: the port of the TPU's double-float stencil
  (JAX ``solver.py:648-676``).
- ``pallas_v1``: the ``pallas`` path without the fused p.Ap: K1 and a torch
  dot (JAX ``solver.py:696-722``, whose K8 computes K1's product).
- ``megakernel`` / ``streamkernel``: the whole solve in one launch of K5 /
  K6 (``ops/cuda/megakernel.py``, ``ops/cuda/streamkernel.py``).
- ``auto``: on a CUDA device ``pallas_fused`` for float32 and float64 and
  ``streamkernel`` for bfloat16; ``stencil`` on the CPU. A fixed choice, not
  a measured crossover: on the H100 ``megakernel`` has since measured faster
  than ``streamkernel`` in bfloat16 (ROADMAP 7b). On the CPU ``auto`` in
  bfloat16 is the all-bf16 ``stencil`` recurrence, on CUDA the whole solve
  with float32 scalars, so the two give results of different precision.

bfloat16 state: ``stencil`` runs the JAX package's all-bf16 ``cg_solve``
(vectors, scalars and trace in bf16; JAX ``solver.py:83-92``);
``megakernel`` and ``streamkernel`` keep the reductions, the scalars and the
trace in float32 (``config.scalar_dtype``). K1-K4 have no bf16 instance yet,
so the other kernel backends refuse bf16.

On the CPU the kernel backends run the kernels' plain versions. The
per-iteration kernel backends compute the initial Ap with K1.

Explicit matrices (:class:`EllMatrix`, :class:`DiaMatrix`; JAX
``solver.py:394-423``, ``:500-528``, ``:724-739``): ``make_cg`` builds the
kernel's layout once (``prepare_dia`` / ``prepare_ell``) and runs
``cg_solve`` with the matrix's own kernel as the matvec (K9/K10 for DIA,
K11/K12 for ELL) and the CUDA finalize step; the dots and axpys stay torch,
as they stay XLA in JAX. ``auto``, ``ell`` and ``dia`` all run the matrix's
own kernel (``ell`` on a DIA matrix runs DIA: JAX's native dispatch);
``stencil`` runs the plain versions with ``cg_finalize_plain``, the plain
baseline on the card; the stencil-only names warn and run ``auto``. K9/K11
have no bf16 instance yet: bfloat16 runs the plain path on the CPU, and on
CUDA only on ``stencil``.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Callable, Optional

import torch

from hpccg_tpu_torch.operators import DiaMatrix, EllMatrix, StencilOperator
from hpccg_tpu_torch.ops.cuda.dia import prepare_dia
from hpccg_tpu_torch.ops.cuda.ell import prepare_ell
from hpccg_tpu_torch.ops.cuda.fused_cg import (
    IC_K,
    SC_NORMR,
    SC_RT_PREV,
    STEP_INIT,
    STEP_PAP,
    STEP_RR,
    CGScalars,
    cg_finalize,
    cg_finalize_plain,
    num_update_partials,
    update_x_r,
)
from hpccg_tpu_torch.ops.cuda.megakernel import cg_solve_mega
from hpccg_tpu_torch.ops.cuda.stencil import (
    num_partials,
    require_f64,
    spmv_stencil,
    spmv_stencil_pap,
    spmv_stencil_pap_dd,
    update_p_apply,
)
from hpccg_tpu_torch.ops.cuda.streamkernel import cg_solve_stream

BACKENDS = ("auto", "stencil", "pallas", "pallas_fused", "pallas_dd", "pallas_v1", "megakernel",
            "streamkernel")
WHOLE_SOLVE_BACKENDS = ("megakernel", "streamkernel")  # one launch per solve
# the backends that take bfloat16 state
BF16_BACKENDS = ("stencil", *WHOLE_SOLVE_BACKENDS)
# what an explicit matrix (EllMatrix, DiaMatrix) dispatches on; other names
# apply to the stencil operator only
EXPLICIT_BACKENDS = ("auto", "stencil", "ell", "dia")


@dataclasses.dataclass(frozen=True)
class CGResult:
    """Solver output, as device tensors. ``trace[k]`` is the residual norm
    printed at iteration k (trace[0] = initial residual); entries past
    ``niters`` are NaN. ``normr`` and ``rtrans`` are the values at the top of
    the last iteration run, the reference's values at loop exit."""

    x: torch.Tensor
    niters: torch.Tensor  # int32, iterations run (== ref niters)
    normr: torch.Tensor
    rtrans: torch.Tensor
    trace: torch.Tensor


def default_check_every(device) -> int:
    return 16 if torch.device(device).type == "cuda" else 1


def _result(x: torch.Tensor, st: CGScalars) -> CGResult:
    return CGResult(
        x=x,
        niters=st.ic[IC_K] - 1,
        normr=st.sc[SC_NORMR].clone(),
        rtrans=st.sc[SC_RT_PREV].clone(),
        trace=st.trace,
    )


def _stopped(st: CGScalars, it: int, check_every: int) -> bool:
    return it % check_every == 0 and int(st.active.item()) == 0


def cg_solve(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    b: torch.Tensor,
    x0: torch.Tensor,
    *,
    max_iter: int,
    tolerance: float = 0.0,
    matvec_pap: Optional[Callable] = None,
    finalize: Callable = cg_finalize,
    check_every: Optional[int] = None,
) -> CGResult:
    """Run CG on flat (n,) vectors.

    ``matvec_pap(p, Ap, active) -> partials``: optional fused variant that
    writes A p into ``Ap`` and returns the partials of p . Ap (K2); without
    it, Ap = matvec(p) and p . Ap is a torch dot. ``finalize`` advances the
    device scalars (``cg_finalize_plain`` keeps the whole solve plain torch).
    """
    check_every = check_every or default_check_every(b.device)
    st = CGScalars.new(b.dtype, max_iter, tolerance, b.device)
    Ap = matvec(x0)
    r = b - Ap
    finalize(torch.dot(r, r).reshape(1), st, STEP_INIT)
    x = x0.clone()
    p = x0
    for it in range(max_iter - 1):
        if _stopped(st, it, check_every):
            break
        p = torch.addcmul(r, st.beta, p)
        if matvec_pap is not None:
            part = matvec_pap(p, Ap, st.active)
        else:
            Ap = matvec(p)
            part = torch.dot(p, Ap).reshape(1)
        finalize(part, st, STEP_PAP)
        x.addcmul_(st.alpha, p)
        r.addcmul_(st.alpha, Ap, value=-1)
        finalize(torch.dot(r, r).reshape(1), st, STEP_RR)
    return _result(x, st)


def cg_solve_fused(
    op: StencilOperator,
    b: torch.Tensor,
    x0: torch.Tensor,
    *,
    max_iter: int,
    tolerance: float = 0.0,
    check_every: Optional[int] = None,
) -> CGResult:
    """CG with two fused passes per iteration: K3 (p-update + SpMV + p.Ap)
    and K4 (x/r update + r.r), each followed by the finalize step. Same
    recurrence as cg_solve; no standalone dot or axpy pass remains."""
    check_every = check_every or default_check_every(b.device)
    g = op.grid
    st = CGScalars.new(b.dtype, max_iter, tolerance, b.device)
    Ap = spmv_stencil(op, g(x0)).reshape(-1)
    r = b - Ap
    cg_finalize(torch.dot(r, r).reshape(1), st, STEP_INIT)
    x = x0.clone()
    p = x0.clone()
    p_next = torch.empty_like(p)
    part3 = torch.empty((num_partials(op, b.device),), dtype=b.dtype, device=b.device)
    part4 = torch.empty((num_update_partials(b.numel(), b.device),), dtype=b.dtype, device=b.device)
    for it in range(max_iter - 1):
        if _stopped(st, it, check_every):
            break
        update_p_apply(op, g(r), g(p), st.beta, out_p=g(p_next), out_ap=g(Ap),
                       partials=part3, active=st.active)
        p, p_next = p_next, p
        cg_finalize(part3, st, STEP_PAP)
        update_x_r(x, r, p, Ap, st.alpha, partials=part4, active=st.active)
        cg_finalize(part4, st, STEP_RR)
    return _result(x, st)


def resolve_backend(backend: str, device, dtype=None) -> str:
    """``auto`` -> on CUDA ``pallas_fused`` (``streamkernel`` for bfloat16),
    ``stencil`` elsewhere (a fixed choice; the JAX package's TPU crossovers
    are not carried over and no H100 crossover is measured yet)."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r} (choose from {BACKENDS})")
    if backend != "auto":
        return backend
    if torch.device(device).type != "cuda":
        return "stencil"
    return "streamkernel" if dtype == torch.bfloat16 else "pallas_fused"


def _check_dtype(backend: str, dtype) -> None:
    """Refuse a dtype the backend's kernels do not take."""
    if backend == "pallas_dd":
        require_f64(dtype)
    if dtype == torch.bfloat16 and backend not in BF16_BACKENDS + ("auto",):
        raise ValueError(f"backend {backend!r} has no bfloat16 kernels yet; bfloat16 state runs on "
                         f"{', '.join(BF16_BACKENDS)}")


def explicit_kernel(A) -> Callable:
    """The SpMV kernel of an explicit matrix, its layout built once here:
    ``fn(x, *, out=None) -> A x`` on K9/K10 for a DiaMatrix and K11/K12 for
    an EllMatrix (the plain versions on the CPU)."""
    return (prepare_dia(A) if isinstance(A, DiaMatrix) else prepare_ell(A)).matvec


def _make_cg_explicit(A, backend: str, **kw) -> Callable[[torch.Tensor, torch.Tensor], CGResult]:
    """make_cg for an EllMatrix or DiaMatrix; ``kw`` are cg_solve's
    max_iter, tolerance and check_every."""
    if backend not in BACKENDS + EXPLICIT_BACKENDS:
        raise ValueError(f"unknown backend {backend!r} (choose from {BACKENDS + EXPLICIT_BACKENDS[2:]})")
    if backend not in EXPLICIT_BACKENDS:
        warnings.warn(f"backend={backend!r} applies to stencil operators only; {type(A).__name__} uses its "
                      "native matvec dispatch", stacklevel=3)
        backend = "auto"
    n = A.local_nrow
    if (A.total_nrow or n) != n or getattr(A, "start_row", 0) != 0:
        raise ValueError("make_cg needs the assembled square matrix, not a row shard")
    if A.dtype == torch.bfloat16 and backend != "stencil" and A.device.type == "cuda":
        raise ValueError(f"backend {backend!r} has no bfloat16 kernels for {type(A).__name__} yet; bfloat16 "
                         "state runs on stencil")
    if backend == "stencil" or A.dtype == torch.bfloat16:
        return lambda b, x0: cg_solve(A.matvec, b, x0, finalize=cg_finalize_plain, **kw)
    matvec = explicit_kernel(A)
    return lambda b, x0: cg_solve(matvec, b, x0, **kw)


def make_cg(
    A,
    *,
    max_iter: Optional[int] = None,
    tolerance: Optional[float] = None,
    backend: str = "auto",
    config=None,
    check_every: Optional[int] = None,
) -> Callable[[torch.Tensor, torch.Tensor], CGResult]:
    """Build a solver fn(b, x0) -> CGResult for A: a StencilOperator, or an
    explicit EllMatrix / DiaMatrix (see the module docstring).

    Solve parameters come from ``max_iter``/``tolerance`` or a
    :class:`SolverConfig` passed as ``config`` (explicit keywords win; with
    neither, max_iter=150 and tolerance=0, the reference's fixed-work
    protocol). The backend resolves on the device and dtype of ``b``;
    a dtype its kernels do not take raises ValueError. ``check_every``: how
    many iterations the per-iteration backends launch between reads of the
    device's exit flag (default 16 on CUDA, 1 on the CPU); the result does
    not depend on it. The whole-solve backends read back once per solve.
    """
    from hpccg_tpu_torch.config import SolverConfig

    base = config if config is not None else SolverConfig()
    max_iter = base.max_iter if max_iter is None else max_iter
    tolerance = base.tolerance if tolerance is None else tolerance
    if isinstance(A, (EllMatrix, DiaMatrix)):
        return _make_cg_explicit(A, backend, max_iter=max_iter, tolerance=tolerance, check_every=check_every)
    if not isinstance(A, StencilOperator):
        raise TypeError(f"make_cg takes a StencilOperator, EllMatrix or DiaMatrix, got {type(A).__name__}")
    resolve_backend(backend, "cpu")  # reject unknown names now
    _check_dtype(backend, A.dtype)
    g = A.grid

    def solve(b: torch.Tensor, x0: torch.Tensor) -> CGResult:
        which = resolve_backend(backend, b.device, b.dtype)
        _check_dtype(which, b.dtype)
        if which in WHOLE_SOLVE_BACKENDS:
            whole = cg_solve_mega if which == "megakernel" else cg_solve_stream
            return whole(A, b, x0, max_iter=max_iter, tolerance=tolerance)
        kw = dict(max_iter=max_iter, tolerance=tolerance, check_every=check_every)
        if which == "pallas_fused":
            return cg_solve_fused(A, b, x0, **kw)
        if which == "pallas_v1":
            return cg_solve(lambda v: spmv_stencil(A, g(v)).reshape(-1), b, x0, **kw)
        if which in ("pallas", "pallas_dd"):
            part = torch.empty((num_partials(A, b.device),), dtype=b.dtype, device=b.device)
            k2 = spmv_stencil_pap_dd if which == "pallas_dd" else spmv_stencil_pap

            def matvec_pap(p, Ap, active):
                return k2(A, g(p), out=g(Ap), partials=part, active=active)[1]

            return cg_solve(lambda v: spmv_stencil(A, g(v)).reshape(-1), b, x0,
                            matvec_pap=matvec_pap, **kw)
        return cg_solve(A.matvec, b, x0, finalize=cg_finalize_plain, **kw)

    return solve
