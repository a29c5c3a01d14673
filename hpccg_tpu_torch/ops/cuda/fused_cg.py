"""Fused CG update K4 and the scalar finalize step (``csrc/fused_cg.cu``):
wrappers, plain versions and launch counters.

- K4 ``update_x_r``: x += alpha p, r -= alpha Ap in place, with per-block
  partials of r . r (``fused_cg.py:_k2``);
- ``cg_finalize``: sums the partials of K2/K3/K4 in a fixed order and
  advances the CG recurrence held in :class:`CGScalars` on the device.

The scalars never leave the device inside an iteration. Each wrapper runs
its plain version only for CPU tensors; for CUDA tensors it launches the
kernel or raises, and counts its launches in ``<wrapper>.launches`` (K4's
bf16 instance in ``launches_bf16`` as well). K4 takes float32, float64 and
bfloat16 vectors; for bf16, alpha and the partials are float32
(``config.scalar_dtype``), the updates computed in float32 and rounded to
bf16 as they are stored, r . r summed over the stored r.
"""

from __future__ import annotations

import dataclasses

import torch

from hpccg_tpu_torch.config import scalar_dtype
from hpccg_tpu_torch.ops.cuda import STENCIL_DTYPES, check_tensors
from hpccg_tpu_torch.ops.cuda.build import check_launch, load_library

# indices into CGScalars.sc and .ic; the same numbers as csrc/fused_cg.cu
SC_RT_CUR, SC_RT_PREV, SC_ALPHA, SC_BETA, SC_NORMR, SC_TOL = range(6)
IC_K, IC_ACTIVE, IC_MAX_ITER = range(3)
# cg_finalize steps: the initial r.r, the p.Ap of a body, the r.r ending it
STEP_INIT, STEP_PAP, STEP_RR = range(3)


@dataclasses.dataclass(frozen=True)
class CGScalars:
    """The CG recurrence's device state (updated in place by cg_finalize).

    ``sc`` (the scalar dtype): rtrans, the previous rtrans, alpha, beta,
    normr, tolerance. ``ic`` (int32): k, active, max_iter. ``trace[k]`` is
    the residual norm at the top of body k (trace[0]: the initial residual);
    entries never reached stay NaN.
    """

    sc: torch.Tensor
    ic: torch.Tensor
    trace: torch.Tensor

    @classmethod
    def new(cls, dtype, max_iter: int, tolerance: float, device) -> "CGScalars":
        """``dtype`` is the scalars' own dtype, which the caller picks apart
        from the vectors': ``config.scalar_dtype`` of the vectors' dtype
        (float32 for bf16 vectors) wherever a kernel runs, on the
        per-iteration kernel backends as in the whole-solve kernels; the
        vectors' dtype on the plain ``stencil`` backend (all-bf16, as the
        JAX package's cg_solve). JAX's per-iteration Pallas backends keep a
        bf16 recurrence (``stencil_v2.py:344-346``, ``fused_cg.py:120-125``);
        the port's differ there (ROADMAP, known divergences)."""
        sc = torch.zeros((8,), dtype=dtype, device=device)
        sc[SC_TOL] = tolerance
        ic = torch.zeros((4,), dtype=torch.int32, device=device)
        ic[IC_MAX_ITER] = max_iter
        trace = torch.full((max(max_iter, 1),), float("nan"), dtype=dtype, device=device)
        return cls(sc=sc, ic=ic, trace=trace)

    @property
    def alpha(self) -> torch.Tensor:
        return self.sc[SC_ALPHA : SC_ALPHA + 1]

    @property
    def beta(self) -> torch.Tensor:
        return self.sc[SC_BETA : SC_BETA + 1]

    @property
    def active(self) -> torch.Tensor:
        return self.ic[IC_ACTIVE : IC_ACTIVE + 1]


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


# --------------------------------------------------------------------- K4


def num_update_partials(n: int, device) -> int:
    """How many partials K4 writes for n elements (1 for the plain version)."""
    if torch.device(device).type != "cuda":
        return 1
    return load_library().hpccg_update_num_blocks(n)


def update_x_r_plain(x, r, p, ap, alpha, *, partials=None, active=None):
    """Plain torch K4: x += alpha p; r -= alpha Ap (in place); [r . r].
    Computed in the scalar dtype, one rounding per operation (bf16 vectors:
    in float32, rounded to bf16 where stored; r . r over the stored r)."""
    sdt = scalar_dtype(x.dtype)
    if partials is None:
        partials = torch.empty((1,), dtype=sdt, device=x.device)
    if active is not None and int(active.item()) == 0:
        return x, r, partials
    x.copy_(x.to(sdt) + alpha * p.to(sdt))
    r.copy_(r.to(sdt) - alpha * ap.to(sdt))
    r32 = r.reshape(-1).to(sdt)
    partials.copy_(torch.dot(r32, r32).reshape(1))
    return x, r, partials


def update_x_r(x, r, p, ap, alpha, *, partials=None, active=None):
    """K4: x += alpha p and r -= alpha Ap, in place; per-block partials of
    the new r . r. Returns (x, r, partials)."""
    shape, sdt = tuple(x.shape), scalar_dtype(x.dtype)
    check_tensors(x, STENCIL_DTYPES, x=(x, None, None), r=(r, shape, None), p=(p, shape, None),
                  ap=(ap, shape, None), alpha=(alpha, (1,), sdt),
                  active=(active, (1,), torch.int32))
    n = x.numel()
    nparts = num_update_partials(n, x.device)
    if partials is None:
        partials = torch.empty((nparts,), dtype=sdt, device=x.device)
    check_tensors(x, STENCIL_DTYPES, partials=(partials, (nparts,), sdt))
    if x.device.type == "cpu":
        return update_x_r_plain(x, r, p, ap, alpha, partials=partials, active=active)
    lib = load_library()
    fn = {torch.float32: lib.hpccg_update_x_r_f32, torch.float64: lib.hpccg_update_x_r_f64,
          torch.bfloat16: lib.hpccg_update_x_r_bf16}[x.dtype]
    # the C entry points launch on the current device, which must be the stream's
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), r.data_ptr(), p.data_ptr(), ap.data_ptr(), alpha.data_ptr(),
                 partials.data_ptr(), None if active is None else active.data_ptr(), n, _stream(x))
    check_launch(err, "update_x_r kernel")
    update_x_r.launches += 1
    if x.dtype == torch.bfloat16:
        update_x_r.launches_bf16 += 1
    return x, r, partials


update_x_r.launches = update_x_r.launches_bf16 = 0


# ---------------------------------------------------------------- finalize


def _top_of_body_plain(st: CGScalars, live: torch.Tensor) -> None:
    """Exit test, then beta, normr and trace[k] for body k (where ``live``)."""
    sc, ic = st.sc, st.ic
    k = ic[IC_K]
    go = live & (k < ic[IC_MAX_ITER]) & (sc[SC_NORMR] > sc[SC_TOL])
    stop = live & ~go
    zero = torch.zeros((), dtype=sc.dtype, device=sc.device)
    beta = torch.where(k == 1, zero, sc[SC_RT_CUR] / sc[SC_RT_PREV])
    normr = torch.sqrt(sc[SC_RT_CUR])
    sc[SC_BETA] = torch.where(go, beta, torch.where(stop, zero, sc[SC_BETA]))
    sc[SC_ALPHA] = torch.where(stop, zero, sc[SC_ALPHA])
    sc[SC_NORMR] = torch.where(go, normr, sc[SC_NORMR])
    idx = k.clamp(0, st.trace.numel() - 1).long().reshape(1)
    st.trace.scatter_(0, idx, torch.where(go, normr, st.trace.gather(0, idx)))
    ic[IC_ACTIVE] = torch.where(live, go.to(torch.int32), ic[IC_ACTIVE])


def cg_finalize_plain(partials, st: CGScalars, step: int) -> None:
    """Plain torch finalize: the same recurrence, without reading anything
    back to the host (predicated with torch.where)."""
    sc, ic = st.sc, st.ic
    s = partials.sum()
    if step == STEP_INIT:
        sc[SC_RT_CUR] = s
        sc[SC_RT_PREV] = s
        sc[SC_NORMR] = torch.sqrt(s)
        st.trace[0] = sc[SC_NORMR]
        ic[IC_K] = 1
        _top_of_body_plain(st, torch.ones((), dtype=torch.bool, device=sc.device))
        return
    live = ic[IC_ACTIVE] != 0
    if step == STEP_PAP:
        sc[SC_ALPHA] = torch.where(live, sc[SC_RT_CUR] / s, sc[SC_ALPHA])
        return
    rt_prev = torch.where(live, sc[SC_RT_CUR], sc[SC_RT_PREV])
    rt_cur = torch.where(live, s, sc[SC_RT_CUR])
    sc[SC_RT_PREV] = rt_prev
    sc[SC_RT_CUR] = rt_cur
    ic[IC_K] = ic[IC_K] + live.to(torch.int32)
    _top_of_body_plain(st, live)


def cg_finalize(partials, st: CGScalars, step: int) -> None:
    """Sum ``partials`` and advance the recurrence one step (STEP_INIT: the
    initial r.r; STEP_PAP: p.Ap -> alpha; STEP_RR: the new r.r -> k+1, the
    exit test, beta, normr, trace[k]). One single-block kernel on CUDA."""
    if step not in (STEP_INIT, STEP_PAP, STEP_RR):
        raise ValueError(f"unknown finalize step {step}")
    check_tensors(st.sc, sc=(st.sc, (8,), None), ic=(st.ic, (4,), torch.int32),
                  trace=(st.trace, None, None), partials=(partials, None, None))
    if partials.dim() != 1 or partials.numel() < 1:
        raise ValueError(f"partials must be a non-empty vector, got shape {tuple(partials.shape)}")
    if st.sc.device.type == "cpu":
        return cg_finalize_plain(partials, st, step)
    lib = load_library()
    fn = lib.hpccg_finalize_f32 if st.sc.dtype == torch.float32 else lib.hpccg_finalize_f64
    # the C entry points launch on the current device, which must be the stream's
    with torch.cuda.device(st.sc.device):
        err = fn(partials.data_ptr(), partials.numel(), st.sc.data_ptr(), st.ic.data_ptr(),
                 st.trace.data_ptr(), step, _stream(st.sc))
    check_launch(err, "finalize kernel")
    cg_finalize.launches += 1


cg_finalize.launches = 0
