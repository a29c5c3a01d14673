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
(vectors, scalars and trace in bf16; JAX ``solver.py:83-92``). The kernel
backends ``pallas``, ``pallas_fused``, ``pallas_v1``, ``megakernel`` and
``streamkernel`` store the vectors in bf16 and keep the reductions, the
scalars and the trace in float32 (``config.scalar_dtype``): K1-K4's bf16
instances compute in f32 and round to bf16 where they store, and the torch
axpys of ``pallas`` / ``pallas_v1`` compute in f32 and store bf16 too. JAX's
``pallas`` keeps its scalars in bf16 there (ROADMAP, known divergences).
``pallas_dd`` is float64 only. cg1 and pipecg keep their scalars in the
vectors' dtype on every backend, as in the JAX package.

On the CPU the kernel backends run the kernels' plain versions. The
per-iteration kernel backends compute the initial Ap with K1.

Methods (JAX ``solver.py:140-311``, ``:529-590``): ``cg`` is the reference
recurrence above; ``cg1`` (Chronopoulos-Gear) and ``pipecg``
(Ghysels-Vanroose) take one fused reduction per iteration, with their
scalars on the device in :class:`OneReductionScalars` (predicated 0-d torch
ops, the exit flag read every ``check_every`` iterations) and optional
residual replacement (``replace_every``). They run on ``stencil``, on K1
(``pallas``, ``pallas_v1``), on K7 (``pallas_dd``) or on an explicit
matrix's kernel; ``cg_solve_refined`` wraps float32 inner solves in float64
refinement rounds.

Every recurrence here also runs on sharded vectors, tuples with one flat
tensor per rank of a mesh: ``parallel.cg.make_distributed_cg`` drives them
with halo'd matvecs.

Explicit matrices (:class:`EllMatrix`, :class:`DiaMatrix`; JAX
``solver.py:394-423``, ``:500-528``, ``:724-739``): ``make_cg`` builds the
kernel's layout once (``prepare_dia`` / ``prepare_ell``) and runs
``cg_solve`` with the matrix's own kernel as the matvec (K9/K10 for DIA,
K11/K12 for ELL) and the CUDA finalize step; the dots and axpys stay torch,
as they stay XLA in JAX. ``auto``, ``ell`` and ``dia`` all run the matrix's
own kernel (``ell`` on a DIA matrix runs DIA: JAX's native dispatch);
``stencil`` runs the plain versions with ``cg_finalize_plain``, the plain
baseline on the card; the stencil-only names warn and run ``auto``.
bfloat16 matrices on CUDA run K9/K11's bf16 instances with float32 scalars,
dots and trace for ``cg`` (``config.scalar_dtype``; cg1 and pipecg keep
bf16 scalars, as everywhere); on ``stencil`` and on the CPU they run the
all-bf16 plain recurrence, the JAX package's (its bf16 file mode is XLA's
DIA/ELL matvec in bf16).
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Callable, Optional

import torch

from hpccg_tpu_torch.config import scalar_dtype
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
# the backends that take bfloat16 state (pallas_dd is float64 only)
BF16_BACKENDS = ("stencil", "pallas", "pallas_fused", "pallas_v1", *WHOLE_SOLVE_BACKENDS)
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


def _result(x, st: CGScalars) -> CGResult:
    return CGResult(
        x=x,
        niters=st.ic[IC_K] - 1,
        normr=st.sc[SC_NORMR].clone(),
        rtrans=st.sc[SC_RT_PREV].clone(),
        trace=st.trace,
    )


def _stopped(st, it: int, check_every: int) -> bool:
    return it % check_every == 0 and int(st.active.item()) == 0


# ------------------------------------------------------------ sharded vectors
#
# The recurrences below run on flat (n,) tensors or on sharded vectors: a
# tuple with one flat tensor per rank of a mesh (``parallel.mesh``), in rank
# order. Internally every vector is a tuple (a flat tensor is one shard);
# the scalars live on the first shard's device, and each rank reads them on
# its own device. A dot product is one partial per rank (per block, for a
# kernel), gathered on the scalars' device in rank order.


def _shards(v) -> tuple:
    return (v,) if isinstance(v, torch.Tensor) else tuple(v)


def _sharded_fn(fn, flat: bool):
    """fn on tuples of shards, for an fn written for a flat tensor when
    ``flat``."""
    return (lambda v: (fn(v[0]),)) if flat else fn


def _dot(u, v, dtype) -> torch.Tensor:
    """u . v as a ``dtype`` scalar, the dtype of the recurrence's scalars.
    For bf16 vectors with float32 scalars, torch.dot would return bf16:
    r . r is then the square of ``vector_norm(dtype=float32)``, whose CUDA
    kernel upcasts as it loads and sums in f32 (no f32 copy of r; the
    squared norm is within an f32 rounding of the sum of squares); u . v of
    two vectors (``pallas_v1``'s p . Ap) takes f32 copies of both, two
    vector writes and reads more than the dot itself."""
    if u.dtype == dtype:
        return torch.dot(u, v)
    if u is v:
        return torch.linalg.vector_norm(u, dtype=dtype).square()
    return torch.dot(u.to(dtype), v.to(dtype))


def _dot_parts(us, vs, device, dtype=None) -> torch.Tensor:
    """Per-rank partials of u . v, in rank order, on ``device``, in
    ``dtype`` (default: the vectors')."""
    dtype = dtype or us[0].dtype
    if len(us) == 1:
        return _dot(us[0], vs[0], dtype).reshape(1)
    return torch.cat([_dot(u, v, dtype).reshape(1).to(device) for u, v in zip(us, vs)])


def _xpby(x, beta, y):
    """x + beta y in the common dtype (float32 for bf16 vectors and float32
    beta), stored in x's dtype."""
    return torch.addcmul(x, beta, y, out=torch.empty_like(x))


def _sub(a, b) -> tuple:
    return tuple(x - y for x, y in zip(a, b))


class RankPartials:
    """Per-rank partial buffers of a kernel (``counts[i]`` on rank i's
    device), gathered in rank order for the finalize step: views of one
    buffer when every rank shares the first rank's device, else copied
    there."""

    def __init__(self, counts, dtype, devices):
        self.device = devices[0]
        self.shared = all(d == self.device for d in devices)
        if self.shared:
            self.flat = torch.empty((sum(counts),), dtype=dtype, device=self.device)
            self.parts = list(self.flat.split(list(counts)))
        else:
            self.parts = [torch.empty((c,), dtype=dtype, device=d) for c, d in zip(counts, devices)]

    def gather(self) -> torch.Tensor:
        return self.flat if self.shared else torch.cat([p.to(self.device) for p in self.parts])


def cg_solve(
    matvec: Callable,
    b,
    x0,
    *,
    max_iter: int,
    tolerance: float = 0.0,
    matvec_pap: Optional[Callable] = None,
    finalize: Callable = cg_finalize,
    check_every: Optional[int] = None,
    scalars: Optional[torch.dtype] = None,
) -> CGResult:
    """Run CG (the reference recurrence) on flat (n,) vectors or on sharded
    vectors (tuples of per-rank shards; the result's x is a tuple then).
    The scalars, the dots and the trace are of dtype ``scalars`` (default:
    the vectors'; the kernel backends pass float32 for bf16 vectors); the
    vector updates compute in the common dtype and store the vectors'.

    ``matvec_pap(p, Ap, active) -> partials``: optional fused variant that
    writes A p into ``Ap`` and returns the partials of p . Ap (K2; for
    shards, every rank's, in rank order); without it, Ap = matvec(p) and
    p . Ap is a torch dot. ``matvec`` and ``matvec_pap`` take what ``b`` is:
    a flat tensor or a tuple of shards. ``finalize`` advances the device
    scalars (``cg_finalize_plain`` keeps the whole solve plain torch).
    """
    flat = isinstance(b, torch.Tensor)
    bs, x0s = _shards(b), _shards(x0)
    dev = bs[0].device
    mv = _sharded_fn(matvec, flat)
    pap = None
    if matvec_pap is not None:
        pap = (lambda p, ap, act: matvec_pap(p[0], ap[0], act)) if flat else matvec_pap
    check_every = check_every or default_check_every(dev)
    sdt = scalars or bs[0].dtype
    st = CGScalars.new(sdt, max_iter, tolerance, dev)
    Ap = mv(x0s)
    r = _sub(bs, Ap)
    finalize(_dot_parts(r, r, dev, sdt), st, STEP_INIT)
    x = tuple(v.clone() for v in x0s)
    p = x0s
    for it in range(max_iter - 1):
        if _stopped(st, it, check_every):
            break
        p = tuple(_xpby(ri, st.beta.to(ri.device), pi) for ri, pi in zip(r, p))
        if pap is not None:
            part = pap(p, Ap, st.active)
        else:
            Ap = mv(p)
            part = _dot_parts(p, Ap, dev, sdt)
        finalize(part, st, STEP_PAP)
        for xi, ri, pi, ai in zip(x, r, p, Ap):
            alpha = st.alpha.to(xi.device)
            xi.addcmul_(alpha, pi)
            ri.addcmul_(alpha, ai, value=-1)
        finalize(_dot_parts(r, r, dev, sdt), st, STEP_RR)
    return _result(x[0] if flat else x, st)


def cg_solve_fused(
    op: StencilOperator,
    b,
    x0,
    *,
    max_iter: int,
    tolerance: float = 0.0,
    check_every: Optional[int] = None,
    halo2: Optional[Callable] = None,
    halo4: Optional[Callable] = None,
) -> CGResult:
    """CG with two fused passes per iteration: K3 (p-update + SpMV + p.Ap)
    and K4 (x/r update + r.r), each followed by the finalize step. Same
    recurrence as cg_solve; no standalone dot or axpy pass remains.

    ``b``/``x0`` are flat or sharded (``op`` is then one rank's block);
    ``halo2(vs)`` / ``halo4(rs, ps)`` give each rank's external z-planes
    ((2, ny, nx) of v, or (4, ny, nx) of r and p; ``parallel.halo``), None
    on a single device."""
    flat = isinstance(b, torch.Tensor)
    bs, x0s = _shards(b), _shards(x0)
    devs = [v.device for v in bs]
    dev = devs[0]
    none = [None] * len(bs)
    halo2 = halo2 or (lambda vs: none)
    halo4 = halo4 or (lambda rs, ps: none)
    check_every = check_every or default_check_every(dev)
    g = op.grid
    sdt = scalar_dtype(bs[0].dtype)
    st = CGScalars.new(sdt, max_iter, tolerance, dev)
    Ap = tuple(spmv_stencil(op, g(v), h).reshape(-1) for v, h in zip(x0s, halo2(x0s)))
    r = _sub(bs, Ap)
    cg_finalize(_dot_parts(r, r, dev, sdt), st, STEP_INIT)
    x = tuple(v.clone() for v in x0s)
    p = tuple(v.clone() for v in x0s)
    p_next = tuple(torch.empty_like(v) for v in p)
    part3 = RankPartials([num_partials(op, d) for d in devs], sdt, devs)
    part4 = RankPartials([num_update_partials(v.numel(), v.device) for v in bs], sdt, devs)
    for it in range(max_iter - 1):
        if _stopped(st, it, check_every):
            break
        for i, h in enumerate(halo4(r, p)):
            d = devs[i]
            update_p_apply(op, g(r[i]), g(p[i]), st.beta.to(d), h, out_p=g(p_next[i]), out_ap=g(Ap[i]),
                           partials=part3.parts[i], active=st.active.to(d))
        p, p_next = p_next, p
        cg_finalize(part3.gather(), st, STEP_PAP)
        for i in range(len(bs)):
            d = devs[i]
            update_x_r(x[i], r[i], p[i], Ap[i], st.alpha.to(d), partials=part4.parts[i], active=st.active.to(d))
        cg_finalize(part4.gather(), st, STEP_RR)
    return _result(x[0] if flat else x, st)


# ------------------------------------------------ one-reduction recurrences

# indices into OneReductionScalars.sc / .ic
G_CUR, G_TOP, A_CUR, A_STEP, B_CUR, G_TOL = range(6)
K_IT, K_ACTIVE, K_MAX = range(3)


@dataclasses.dataclass(frozen=True)
class OneReductionScalars:
    """The device state of cg1 and pipecg: ``sc`` (the vector dtype) holds
    gamma = r.r, gamma_top (the gamma a reference body would test at its
    top: one update older), alpha, the step the x update takes (alpha while
    active, else 0), beta and the tolerance; ``ic`` (int32) k, active,
    max_iter; ``trace[k]`` = sqrt(gamma) at the top of body k."""

    sc: torch.Tensor
    ic: torch.Tensor
    trace: torch.Tensor

    @classmethod
    def new(cls, dtype, max_iter: int, tolerance: float, device) -> "OneReductionScalars":
        sc = torch.zeros((8,), dtype=dtype, device=device)
        sc[G_TOL] = tolerance
        ic = torch.zeros((4,), dtype=torch.int32, device=device)
        ic[K_MAX] = max_iter
        trace = torch.full((max(max_iter, 1),), float("nan"), dtype=dtype, device=device)
        return cls(sc=sc, ic=ic, trace=trace)

    @property
    def active(self) -> torch.Tensor:
        return self.ic[K_ACTIVE : K_ACTIVE + 1]

    def init(self, gd: torch.Tensor) -> None:
        """gd = the reduced (gamma, delta) of the initial residual."""
        sc, ic = self.sc, self.ic
        sc[G_CUR] = gd[0]
        sc[G_TOP] = gd[0]
        sc[A_CUR] = gd[0] / gd[1]
        self.trace[0] = torch.sqrt(gd[0])
        ic[K_IT] = 1
        ic[K_ACTIVE] = 1

    def top(self) -> None:
        """The loop test (k < max_iter and sqrt(gamma_top) > tol), then
        trace[k] and the x step for body k, predicated on the result."""
        sc, ic = self.sc, self.ic
        k = ic[K_IT]
        go = (ic[K_ACTIVE] != 0) & (k < ic[K_MAX]) & (torch.sqrt(sc[G_TOP]) > sc[G_TOL])
        ic[K_ACTIVE] = go.to(torch.int32)
        idx = k.clamp(0, self.trace.numel() - 1).long().reshape(1)
        self.trace.scatter_(0, idx, torch.where(go, torch.sqrt(sc[G_CUR]), self.trace.gather(0, idx)))
        sc[A_STEP] = torch.where(go, sc[A_CUR], torch.zeros((), dtype=sc.dtype, device=sc.device))

    def advance(self, gd: torch.Tensor) -> None:
        """The end of body k from the reduced (gamma', delta): beta and the
        next alpha; gamma_top, gamma, alpha and k move only while active."""
        sc, ic = self.sc, self.ic
        live = ic[K_ACTIVE] != 0
        g_new, delta = gd[0], gd[1]
        beta = g_new / sc[G_CUR]
        alpha = g_new / (delta - beta * g_new / sc[A_CUR])
        sc[G_TOP] = torch.where(live, sc[G_CUR], sc[G_TOP])
        sc[G_CUR] = torch.where(live, g_new, sc[G_CUR])
        sc[A_CUR] = torch.where(live, alpha, sc[A_CUR])
        sc[B_CUR] = beta
        ic[K_IT] = ic[K_IT] + live.to(torch.int32)

    def result(self, x) -> CGResult:
        return CGResult(x=x, niters=self.ic[K_IT] - 1, normr=torch.sqrt(self.sc[G_TOP]),
                        rtrans=self.sc[G_TOP].clone(), trace=self.trace)


def _rank_dot2(p1, p2, device) -> torch.Tensor:
    """(a1 . b1, a2 . b2) summed over the ranks in rank order, on
    ``device``: the all-reduce of the one-reduction methods."""
    (a1, b1), (a2, b2) = p1, p2
    parts = [torch.stack([torch.dot(u1, v1), torch.dot(u2, v2)]) for u1, v1, u2, v2 in zip(a1, b1, a2, b2)]
    total = parts[0].to(device)
    for part in parts[1:]:
        total = total + part.to(device)
    return total


def _one_reduction(step_fn, matvec, b, x0, max_iter, tolerance, replace_every, check_every):
    """The host loop shared by cg1 and pipecg: ``step_fn`` gives the init
    and body of one method over sharded vectors."""
    flat = isinstance(b, torch.Tensor)
    bs, x0s = _shards(b), _shards(x0)
    dev = bs[0].device
    mv = _sharded_fn(matvec, flat)
    check_every = check_every or default_check_every(dev)
    st = OneReductionScalars.new(bs[0].dtype, max_iter, tolerance, dev)

    def dot2(p1, p2):
        return _rank_dot2(p1, p2, dev)

    def axpy_(y, x, sign=1.0):  # y += sign * (alpha step) * x, per rank
        for yi, xi in zip(y, x):
            yi.addcmul_(st.sc[A_STEP : A_STEP + 1].to(yi.device), xi, value=sign)

    def xpby(x, y):  # x + beta * y, per rank
        return tuple(torch.addcmul(xi, st.sc[B_CUR : B_CUR + 1].to(xi.device), yi) for xi, yi in zip(x, y))

    state = step_fn.init(mv, bs, x0s, st, dot2)
    for it in range(max_iter - 1):
        if _stopped(st, it, check_every):
            break
        st.top()
        k = it + 1  # body k while active; after the exit nothing it computes is kept
        replace = bool(replace_every) and k % replace_every == 0
        state = step_fn.body(mv, bs, state, st, dot2, axpy_, xpby, replace)
    return st.result(state[0][0] if flat else state[0])


class _CG1:
    """Chronopoulos-Gear (``hpccg_tpu.solver.cg_solve_single_reduction``):
    state (x, r, p, s = A p by recurrence)."""

    @staticmethod
    def init(mv, bs, x0s, st, dot2):
        r = _sub(bs, mv(x0s))
        u = mv(r)
        st.init(dot2((r, r), (r, u)))
        return tuple(v.clone() for v in x0s), r, tuple(v.clone() for v in r), u

    @staticmethod
    def body(mv, bs, state, st, dot2, axpy_, xpby, replace):
        x, r, p, s = state
        axpy_(x, p)
        axpy_(r, s, -1.0)
        if replace:
            r = _sub(bs, mv(x))
        u = mv(r)
        st.advance(dot2((r, r), (r, u)))
        return x, r, xpby(r, p), xpby(u, s)


class _PipeCG:
    """Ghysels-Vanroose (``hpccg_tpu.solver.cg_solve_pipelined``): state
    (x, r, w = A r, p, s = A p, z = A s), and q = A w is the one matvec of
    a body, independent of its reduction."""

    @staticmethod
    def init(mv, bs, x0s, st, dot2):
        r = _sub(bs, mv(x0s))
        w = mv(r)
        gd = dot2((r, r), (w, r))
        q = mv(w)
        st.init(gd)
        clone = lambda vs: tuple(v.clone() for v in vs)  # noqa: E731
        return clone(x0s), r, clone(w), clone(r), w, q

    @staticmethod
    def body(mv, bs, state, st, dot2, axpy_, xpby, replace):
        x, r, w, p, s, z = state
        axpy_(x, p)
        axpy_(r, s, -1.0)
        axpy_(w, z, -1.0)
        if replace:
            r = _sub(bs, mv(x))
            w = mv(r)
        gd = dot2((r, r), (w, r))
        q = mv(w)
        st.advance(gd)
        return x, r, w, xpby(r, p), xpby(w, s), xpby(q, z)


def cg_solve_single_reduction(matvec: Callable, b, x0, *, max_iter: int, tolerance: float = 0.0,
                              replace_every: int = 0, check_every: Optional[int] = None) -> CGResult:
    """Chronopoulos-Gear single-reduction CG (JAX ``solver.py:140-228``):
    one fused (r.r, r.u) reduction per iteration, s = A p kept by the
    recurrence s' = u + beta s (u = A r). ``b``/``x0`` flat or sharded, as
    for cg_solve; the reduction sums the ranks' pairs in rank order.

    The loop tests and the result reports gamma_top, the r.r a reference
    body would test at its top (one update older than the newest gamma):
    normr = sqrt(gamma_top), rtrans = gamma_top. In f32 the recurrence
    residual decays below the true residual's floor and flushes to exact 0
    (near iteration 140 at 100^3), which ends a tolerance-0 run; on exact
    convergence alpha = 0/0 turns x to NaN one iteration later, as in the
    JAX package. ``replace_every=K``: every K iterations r is replaced by
    the true b - A x (one extra matvec); p is kept."""
    return _one_reduction(_CG1, matvec, b, x0, max_iter, tolerance, replace_every, check_every)


def cg_solve_pipelined(matvec: Callable, b, x0, *, max_iter: int, tolerance: float = 0.0,
                       replace_every: int = 0, check_every: Optional[int] = None) -> CGResult:
    """Ghysels-Vanroose pipelined CG (JAX ``solver.py:231-311``): w = A r,
    s = A p and z = A s by recurrences, so the body's one matvec q = A w
    does not wait for its reduction. Exit semantics as
    cg_solve_single_reduction; ``replace_every=K`` replaces r by b - A x and
    w by A r every K iterations (two extra matvecs)."""
    return _one_reduction(_PipeCG, matvec, b, x0, max_iter, tolerance, replace_every, check_every)


ONE_REDUCTION = {"cg1": cg_solve_single_reduction, "pipecg": cg_solve_pipelined}
METHODS = ("cg", *ONE_REDUCTION)
# the backends that run the reference recurrence only: a one-reduction
# method warns and runs on `pallas` (JAX solver.py:533-546)
CG_ONLY_BACKENDS = ("megakernel", "streamkernel", "pallas_fused")


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
    """Refuse a dtype the backend's kernels do not take: ``pallas_dd``
    takes float64 only, every other backend float32, float64 and
    bfloat16."""
    if backend == "pallas_dd":
        require_f64(dtype)
    if dtype == torch.bfloat16 and backend not in BF16_BACKENDS + ("auto",):
        raise ValueError(f"backend {backend!r} takes no bfloat16; bfloat16 state runs on "
                         f"{', '.join(BF16_BACKENDS)}")


def check_method(method: str) -> None:
    if method not in METHODS:
        raise ValueError(f"unknown CG method {method!r} (choose from {METHODS})")


def solve_backend(backend: str, method: str, device, dtype=None) -> str:
    """The backend a make_cg solve on ``device`` runs: ``auto`` resolved,
    and ``pallas`` for a one-reduction method on a backend that runs the
    reference recurrence only."""
    which = resolve_backend(backend, device, dtype)
    return "pallas" if method != "cg" and which in CG_ONLY_BACKENDS else which


def warn_cg_only(backend: str, method: str) -> str:
    """The backend a one-reduction method runs on: ``pallas`` in place of a
    backend that runs the reference recurrence only, with JAX's warning."""
    if method != "cg" and backend in CG_ONLY_BACKENDS:
        warnings.warn(f"backend={backend!r} implements method='cg' only; method={method!r} runs on the "
                      "per-iteration pallas SpMV path instead", stacklevel=3)
        return "pallas"
    return backend


def stencil_kernel_matvec(op: StencilOperator, backend: str, device, dtype) -> Callable:
    """The flat A v of a one-reduction method on ``backend``: the plain
    matvec on ``stencil``, K1 on ``pallas`` / ``pallas_v1``, K7's product on
    ``pallas_dd`` (its partials unused)."""
    g = op.grid
    if backend == "stencil":
        return op.matvec
    if backend == "pallas_dd":
        part = torch.empty((num_partials(op, device),), dtype=dtype, device=device)
        return lambda v: spmv_stencil_pap_dd(op, g(v), partials=part)[0].reshape(-1)
    return lambda v: spmv_stencil(op, g(v)).reshape(-1)


def explicit_kernel(A) -> Callable:
    """The SpMV kernel of an explicit matrix, its layout built once here:
    ``fn(x, *, out=None) -> A x`` on K9/K10 for a DiaMatrix and K11/K12 for
    an EllMatrix (the plain versions on the CPU)."""
    return (prepare_dia(A) if isinstance(A, DiaMatrix) else prepare_ell(A)).matvec


def _make_cg_explicit(A, backend: str, method: str, replace_every: int,
                      **kw) -> Callable[[torch.Tensor, torch.Tensor], CGResult]:
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
    plain = backend == "stencil" or (A.dtype == torch.bfloat16 and A.device.type != "cuda")
    matvec = A.matvec if plain else explicit_kernel(A)
    if method != "cg":
        solver_fn = ONE_REDUCTION[method]
        return lambda b, x0: solver_fn(matvec, b, x0, replace_every=replace_every, **kw)
    if plain:
        return lambda b, x0: cg_solve(matvec, b, x0, finalize=cg_finalize_plain, **kw)
    return lambda b, x0: cg_solve(matvec, b, x0, scalars=scalar_dtype(A.dtype), **kw)


def make_cg(
    A,
    *,
    max_iter: Optional[int] = None,
    tolerance: Optional[float] = None,
    backend: str = "auto",
    method: str = "cg",
    replace_every: int = 0,
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

    ``method``: ``cg`` (the reference recurrence), ``cg1`` or ``pipecg``
    (the one-reduction recurrences; on ``stencil``, on K1 for ``pallas``,
    ``pallas_v1`` and ``auto`` on CUDA, on K7 for ``pallas_dd``, on an
    explicit matrix's own kernel; ``megakernel``, ``streamkernel`` and
    ``pallas_fused`` warn and run ``pallas``). ``replace_every``: residual
    replacement every K iterations for cg1/pipecg; ignored for cg.
    """
    from hpccg_tpu_torch.config import SolverConfig

    base = config if config is not None else SolverConfig()
    max_iter = base.max_iter if max_iter is None else max_iter
    tolerance = base.tolerance if tolerance is None else tolerance
    check_method(method)
    kw = dict(max_iter=max_iter, tolerance=tolerance, check_every=check_every)
    if isinstance(A, (EllMatrix, DiaMatrix)):
        return _make_cg_explicit(A, backend, method, replace_every, **kw)
    if not isinstance(A, StencilOperator):
        raise TypeError(f"make_cg takes a StencilOperator, EllMatrix or DiaMatrix, got {type(A).__name__}")
    resolve_backend(backend, "cpu")  # reject unknown names now
    backend = warn_cg_only(backend, method)
    _check_dtype(backend, A.dtype)
    g = A.grid

    def solve(b: torch.Tensor, x0: torch.Tensor) -> CGResult:
        which = solve_backend(backend, method, b.device, b.dtype)
        if method != "cg":
            _check_dtype(which, b.dtype)
            matvec = stencil_kernel_matvec(A, which, b.device, b.dtype)
            return ONE_REDUCTION[method](matvec, b, x0, replace_every=replace_every, **kw)
        _check_dtype(which, b.dtype)
        if which in WHOLE_SOLVE_BACKENDS:
            whole = cg_solve_mega if which == "megakernel" else cg_solve_stream
            return whole(A, b, x0, max_iter=max_iter, tolerance=tolerance)
        if which == "pallas_fused":
            return cg_solve_fused(A, b, x0, **kw)
        sdt = scalar_dtype(b.dtype)
        if which == "pallas_v1":
            return cg_solve(lambda v: spmv_stencil(A, g(v)).reshape(-1), b, x0, scalars=sdt, **kw)
        if which in ("pallas", "pallas_dd"):
            part = torch.empty((num_partials(A, b.device),), dtype=sdt, device=b.device)
            k2 = spmv_stencil_pap_dd if which == "pallas_dd" else spmv_stencil_pap

            def matvec_pap(p, Ap, active):
                return k2(A, g(p), out=g(Ap), partials=part, active=active)[1]

            return cg_solve(lambda v: spmv_stencil(A, g(v)).reshape(-1), b, x0,
                            matvec_pap=matvec_pap, scalars=sdt, **kw)
        return cg_solve(A.matvec, b, x0, finalize=cg_finalize_plain, **kw)

    return solve


def cg_solve_refined(
    A,
    b: torch.Tensor,
    x0: torch.Tensor,
    *,
    inner_max_iter: int = 150,
    outer_max_iter: int = 6,
    tolerance: float = 0.0,
    backend: str = "auto",
    method: str = "cg",
    replace_every: int = 0,
) -> CGResult:
    """Mixed-precision iterative refinement (JAX ``solver.py:742-823``):
    float32 inner CG solves of A d = r / |r| (relative tolerance 1e-6), the
    residual r = b - A x and x in float64, one f64 matvec per outer round.

    b/x0 must be float64. The result's trace holds the outer residual norms
    (length outer_max_iter + 1, NaN past the last round) and niters counts
    the inner iterations of all rounds."""
    if b.dtype != torch.float64:
        raise ValueError("cg_solve_refined expects float64 b/x0")
    if isinstance(A, StencilOperator):
        A32 = dataclasses.replace(A, dtype=torch.float32)
    elif isinstance(A, EllMatrix):
        A32 = dataclasses.replace(A, vals=A.vals.float())
    else:
        A32 = dataclasses.replace(A, data=A.data.float())
    inner = make_cg(A32, max_iter=inner_max_iter, tolerance=1e-6, backend=backend, method=method,
                    replace_every=replace_every)
    x = x0
    trace = []
    total_inner = 0
    r64 = b - A.matvec(x)
    normr = float(torch.sqrt(torch.dot(r64, r64)))
    trace.append(normr)
    for _ in range(outer_max_iter):
        scale = normr
        if scale <= tolerance or scale == 0.0:
            break
        rhs32 = (r64 / scale).to(torch.float32)
        res = inner(rhs32, torch.zeros_like(rhs32))
        total_inner += int(res.niters)
        x = x + scale * res.x.to(b.dtype)
        r64 = b - A.matvec(x)
        normr = float(torch.sqrt(torch.dot(r64, r64)))
        trace.append(normr)
    trace_t = torch.full((outer_max_iter + 1,), float("nan"), dtype=b.dtype, device=b.device)
    trace_t[: len(trace)] = torch.tensor(trace, dtype=b.dtype)
    return CGResult(
        x=x,
        niters=torch.tensor(total_inner, dtype=torch.int32, device=b.device),
        normr=torch.tensor(normr, dtype=b.dtype, device=b.device),
        rtrans=torch.tensor(normr**2, dtype=b.dtype, device=b.device),
        trace=trace_t,
    )
