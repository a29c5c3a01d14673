"""The port's whole-solve backends (K5 ``megakernel``, K6 ``streamkernel``)
against the JAX package's whole-solve Pallas kernels, and ``pallas_dd``.

On the CPU ``make_cg(..., backend="megakernel"|"streamkernel")`` runs the
kernels' plain versions; the Pallas kernels run in interpret mode, as the
JAX package's own tests run them. Both sides solve the very same system:
the JAX problem, carried across with ``convert.problem_from_numpy``. K5 is
held against both of the TPU kernel's modes (``cg_mega_padded`` whole and
slab: one computation, two VMEM layouts), K6 against ``cg_stream_padded``.

Tolerances, and why:

- float64: niters equal, trace rtol 1e-10 above 1e-11 * trace[0], x rtol
  1e-12. The recurrence is the same; the sums run in another order.
- float32: trace rtol 1e-4 above 1e-5 * trace[0]. Below that the
  recurrence residual follows each run's rounding (ROADMAP queue 3).
- bfloat16, compared in float32: x is bf16, trace and normr float32,
  niters int32 and equal to JAX's; max|x - 1| < 0.1; the trace within 5e-2
  of JAX's while it stays above 1e-3 * trace[0]. The port computes in f32
  and rounds to bf16 when it stores p', Ap', r and x; the TPU kernels also
  round their elementwise arithmetic to bf16. Measured: the two agree to
  6.1e-3 at 12x10x9 and 3.2e-2 at 7x11x3 over the first ten 27-point
  iterations. 7-point runs converge about ten times per iteration and stop
  at 15 iterations, before r.r can flush to 0.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import hpccg_tpu  # noqa: E402
from hpccg_tpu.ops.pallas.megakernel import MEGA_TZ, cg_mega_padded, cg_solve_mega  # noqa: E402
from hpccg_tpu.ops.pallas.stencil_v2 import pad_plane3, unpad_plane3  # noqa: E402
from hpccg_tpu.ops.pallas.streamkernel import _stream_tz, cg_stream_padded  # noqa: E402
from hpccg_tpu_torch import ProblemConfig, generate_problem, make_cg  # noqa: E402
from hpccg_tpu_torch.convert import problem_from_numpy  # noqa: E402
from hpccg_tpu_torch.ops.cuda import megakernel as mk  # noqa: E402
from hpccg_tpu_torch.ops.cuda import streamkernel as sk  # noqa: E402

from oracle import GOLDEN_10_NITERS, GOLDEN_10_TRACE  # noqa: E402

# JAX whole-solve mode -> the port's backend that ports it
MODES = {"mega_whole": "megakernel", "mega_slab": "megakernel", "stream": "streamkernel"}
DIMS = [(12, 10, 9), (7, 11, 3)]
TRACE_TOL = {"float64": (1e-10, 1e-11), "float32": (1e-4, 1e-5), "bfloat16": (5e-2, 1e-3)}


def _problems(dims, stencil, dtype):
    jprob = hpccg_tpu.generate_problem(hpccg_tpu.ProblemConfig(*dims, stencil=stencil, dtype=getattr(jnp, dtype)))
    prob = problem_from_numpy(*dims, stencil, np.asarray(jprob.b), np.asarray(jprob.x0),
                              np.asarray(jprob.xexact), device="cpu")
    return jprob, prob


def _jax_solve(mode, jprob, max_iter, tolerance=0.0):
    """One JAX whole-solve kernel in interpret mode -> (x, trace, niters,
    normr) as numpy."""
    A = jprob.A
    if mode == "stream":
        tz = _stream_tz(A, jprob.b.dtype)
        x, trace, stats = cg_stream_padded(A, pad_plane3(A, jprob.b, tz), pad_plane3(A, jprob.x0, tz),
                                           max_iter, tolerance)
    else:
        slab = mode == "mega_slab"
        tz = MEGA_TZ if slab else 1
        x, trace, stats = cg_mega_padded(A, pad_plane3(A, jprob.b, tz), pad_plane3(A, jprob.x0, tz),
                                         max_iter, tolerance, False, slab)
    return (np.asarray(unpad_plane3(A, x)), np.asarray(trace[:, 0]), int(stats[0, 2]),
            float(stats[0, 0]))


def _head(jt, dtype):
    rtol, floor = TRACE_TOL[dtype]
    return rtol, np.isfinite(jt) & (jt > floor * jt[0])


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("stencil", [27, 7])
@pytest.mark.parametrize("dims", DIMS, ids=["12x10x9", "7x11x3"])
def test_whole_solve_matches_jax(dims, stencil, dtype, mode):
    jprob, prob = _problems(dims, stencil, dtype)
    jx, jt, jn, _ = _jax_solve(mode, jprob, 30)
    res = make_cg(prob.A, max_iter=30, backend=MODES[mode])(prob.b, prob.x0)
    t = res.trace.numpy()
    assert t.dtype == jt.dtype and res.x.dtype == getattr(torch, dtype)
    rtol, head = _head(jt, dtype)
    assert head[:5].all()
    np.testing.assert_allclose(t[head], jt[head], rtol=rtol)
    if dtype == "float64":
        assert int(res.niters) == jn == 29
        np.testing.assert_allclose(res.x.numpy(), jx, rtol=1e-12)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("stencil", [27, 7])
@pytest.mark.parametrize("dims", DIMS, ids=["12x10x9", "7x11x3"])
def test_whole_solve_bf16_matches_jax(dims, stencil, mode):
    jprob, prob = _problems(dims, stencil, "bfloat16")
    max_iter = 30 if stencil == 27 else 15
    _, jt, jn, _ = _jax_solve(mode, jprob, max_iter)
    res = make_cg(prob.A, max_iter=max_iter, backend=MODES[mode])(prob.b, prob.x0)
    assert res.x.dtype == torch.bfloat16 and res.niters.dtype == torch.int32
    assert res.trace.dtype == res.normr.dtype == res.rtrans.dtype == torch.float32
    assert int(res.niters) == jn == max_iter - 1
    assert float((res.x.float() - 1).abs().max()) < 0.1
    rtol, head = _head(jt, "bfloat16")
    assert head[:3].all()
    np.testing.assert_allclose(res.trace.numpy()[head], jt[head], rtol=rtol)


@pytest.mark.parametrize("backend", ["megakernel", "streamkernel"])
def test_bf16_niters_exact_past_256(backend):
    """bf16 state keeps its count in int32 (the JAX kernels in f32): a
    tolerance-0 solve of 300 iterations reports 299 on both sides.

    At this size both sides' residuals stagnate. A tolerance-0 bf16 solve
    ends in one of two ways: the recurrence stagnates at the bf16 storage
    floor (and runs to max_iter), or r.r flushes to 0 in f32 first (and the
    loop exits, as f32 solves of small problems do). The port computes in
    f32 and reaches the floor later than the TPU kernels, which round every
    elementwise step to bf16; which end it meets depends on the rounding:
    at 12x10x9 its r.r flushes after 68 (K5) / 65 (K6) iterations, where
    the JAX kernels stagnate at 299."""
    jprob, prob = _problems((32, 32, 32), 27, "bfloat16")
    res = make_cg(prob.A, max_iter=300, backend=backend)(prob.b, prob.x0)
    jn = _jax_solve("mega_whole" if backend == "megakernel" else "stream", jprob, 300)[2]
    assert int(res.niters) == jn == 299
    assert float(res.normr) > 0 and np.isfinite(res.trace.numpy()).all()


@pytest.mark.parametrize("backend", ["megakernel", "streamkernel", "pallas_dd"])
def test_golden_out_txt_parity(backend):
    """The reference's checked-in run: 10^3, f64, max_iter 150, 149 iterations."""
    prob = generate_problem(ProblemConfig(10, 10, 10), "cpu")
    res = make_cg(prob.A, max_iter=150, tolerance=0.0, backend=backend)(prob.b, prob.x0)
    trace = res.trace.numpy()
    assert int(res.niters) == GOLDEN_10_NITERS
    np.testing.assert_allclose(trace[0], GOLDEN_10_TRACE[0], rtol=1e-5)
    np.testing.assert_allclose(trace[15], GOLDEN_10_TRACE[15], rtol=1e-4)
    for k, ref in GOLDEN_10_TRACE.items():
        if k > 15:
            assert abs(np.log10(trace[k]) - np.log10(ref)) < 0.05 * abs(np.log10(ref)) + 1.0


@pytest.mark.parametrize("backend", ["megakernel", "streamkernel"])
def test_tolerance_early_exit_matches_jax_megakernel(backend):
    """The exit test reads the normr of the previous body's top, as the JAX
    kernels' while_loop does: niters and normr agree; rtrans is normr^2."""
    jprob, prob = _problems((8, 8, 8), 27, "float64")
    jres = cg_solve_mega(jprob.A, jprob.b, jprob.x0, max_iter=500, tolerance=1e-10)
    res = make_cg(prob.A, max_iter=500, tolerance=1e-10, backend=backend)(prob.b, prob.x0)
    assert int(res.niters) == int(jres.niters) < 499
    np.testing.assert_allclose(float(res.normr), float(jres.normr), rtol=1e-6)
    np.testing.assert_allclose(float(res.rtrans), float(res.normr) ** 2, rtol=1e-12)
    trace = res.trace.numpy()
    assert np.isnan(trace[int(res.niters) + 1:]).all()
    assert np.isfinite(trace[: int(res.niters) + 1]).all()


def test_wrappers_take_cpu_tensors_through_the_plain_versions():
    """On the CPU each wrapper is its plain version (no launch counted), and
    it refuses what the kernel does not take."""
    prob = generate_problem(ProblemConfig(6, 5, 4, dtype=torch.float32), "cpu")
    before = (mk.cg_solve_mega.launches, sk.cg_solve_stream.launches)
    for kern, plain in ((mk.cg_solve_mega, mk.cg_solve_mega_plain), (sk.cg_solve_stream, sk.cg_solve_stream_plain)):
        a = kern(prob.A, prob.b, prob.x0, max_iter=12)
        b = plain(prob.A, prob.b, prob.x0, max_iter=12)
        assert torch.equal(a.x, b.x) and torch.equal(a.trace, b.trace) and int(a.niters) == 11
        with pytest.raises(TypeError):
            kern(prob.A, prob.b.double(), prob.x0.double().to(torch.int64), max_iter=3)
        with pytest.raises(ValueError):
            kern(prob.A, prob.b[:-1], prob.x0[:-1], max_iter=3)
        with pytest.raises(ValueError):
            kern(prob.A, prob.b, prob.b, max_iter=3)
    assert (mk.cg_solve_mega.launches, sk.cg_solve_stream.launches) == before


def test_bf16_backend_choice():
    prob = generate_problem(ProblemConfig(6, 5, 4, dtype=torch.bfloat16), "cpu")
    from hpccg_tpu_torch.solver import resolve_backend

    assert resolve_backend("auto", "cuda", torch.bfloat16) == "streamkernel"
    assert resolve_backend("auto", "cuda", torch.float32) == "pallas_fused"
    assert resolve_backend("auto", "cpu", torch.bfloat16) == "stencil"
    for backend in ("pallas", "pallas_fused", "pallas_v1"):  # K1-K4's bf16 instances (plain here)
        res = make_cg(prob.A, max_iter=8, backend=backend)(prob.b, prob.x0)
        assert res.x.dtype == torch.bfloat16 and res.trace.dtype == torch.float32 and int(res.niters) == 7
    for dtype in (torch.bfloat16, torch.float32):
        with pytest.raises(ValueError, match="pallas_dd"):
            make_cg(generate_problem(ProblemConfig(4, 4, 4, dtype=dtype), "cpu").A, backend="pallas_dd")


def test_stencil_bf16_is_the_all_bf16_recurrence():
    """``stencil`` in bf16 runs JAX's cg_solve in bf16: vectors, scalars and
    trace all bf16 (niters int32). Its trace tracks JAX's while it stays
    above 1e-2 * trace[0] (measured within 1.5e-2 at 12x10x9)."""
    from hpccg_tpu.solver import make_cg as jmake_cg

    jprob, prob = _problems((12, 10, 9), 27, "bfloat16")
    jres = jmake_cg(jprob.A, max_iter=20, backend="stencil")(jprob.b, jprob.x0)
    res = make_cg(prob.A, max_iter=20, backend="stencil")(prob.b, prob.x0)
    assert res.trace.dtype == res.normr.dtype == res.x.dtype == torch.bfloat16
    assert int(res.niters) == int(jres.niters) == 19
    jt, t = np.asarray(jres.trace).astype(np.float32), res.trace.float().numpy()
    head = jt > 1e-2 * jt[0]
    assert head[:4].all()
    np.testing.assert_allclose(t[head], jt[head], rtol=5e-2)
