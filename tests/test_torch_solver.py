"""The port's CG solver against the reference's golden run and against
``hpccg_tpu.make_cg`` on the very same system (carried across as numpy).

On the CPU the ``pallas`` and ``pallas_fused`` backends run the kernels'
plain versions, with the same control flow as on the card.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import hpccg_tpu  # noqa: E402
from hpccg_tpu.solver import make_cg as jmake_cg  # noqa: E402
from hpccg_tpu_torch import ProblemConfig, SolverConfig, generate_problem, make_cg  # noqa: E402
from hpccg_tpu_torch.convert import (  # noqa: E402
    problem_from_numpy,
    problem_to_numpy,
    result_from_numpy,
    result_to_numpy,
)
from hpccg_tpu_torch.solver import resolve_backend  # noqa: E402

from oracle import GOLDEN_10_NITERS, GOLDEN_10_TRACE  # noqa: E402

BACKENDS = ["stencil", "pallas", "pallas_fused"]
# Below the true residual's stagnation floor the recurrence residual follows
# each run's rounding, and two runs that sum in different orders part there
# (tests/test_solver.py masks the same way). At 12x10x9 the f64 traces agree
# to 1e-14 down to 1e-11 of trace[0] and part by 1e-10 at 1e-12; the f32
# traces agree to 1e-5 down to 1e-5 of trace[0] and part by 6e-3 at 2e-7.
# Each trace is held to its rtol above its floor.
FLOOR = {"float64": 1e-11, "float32": 1e-5}


def _golden_checks(trace, niters):
    assert niters == GOLDEN_10_NITERS
    np.testing.assert_allclose(trace[0], GOLDEN_10_TRACE[0], rtol=1e-5)
    np.testing.assert_allclose(trace[15], GOLDEN_10_TRACE[15], rtol=1e-4)
    # deep-convergence tail: the decay rate is spectrum-driven, rounding
    # noise compounds, so compare orders of magnitude (tests/test_solver.py)
    for k, ref in GOLDEN_10_TRACE.items():
        if k > 15:
            assert abs(np.log10(trace[k]) - np.log10(ref)) < 0.05 * abs(np.log10(ref)) + 1.0


@pytest.mark.parametrize("backend", BACKENDS)
def test_golden_out_txt_parity(backend):
    """The reference's checked-in run: 10^3, f64, max_iter 150, 149 iterations."""
    prob = generate_problem(ProblemConfig(10, 10, 10), "cpu")
    res = make_cg(prob.A, max_iter=150, tolerance=0.0, backend=backend)(prob.b, prob.x0)
    _golden_checks(res.trace.numpy(), int(res.niters))


def _jax_and_port(dims, dtype):
    nx, ny, nz = dims
    jprob = hpccg_tpu.generate_problem(hpccg_tpu.ProblemConfig(nx, ny, nz, dtype=getattr(jnp, dtype)))
    prob = problem_from_numpy(
        nx, ny, nz, 27, np.asarray(jprob.b), np.asarray(jprob.x0), np.asarray(jprob.xexact), device="cpu"
    )
    return jprob, prob


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("backend", BACKENDS)
def test_trajectory_matches_jax(backend, dtype):
    jprob, prob = _jax_and_port((12, 10, 9), dtype)
    jres = jmake_cg(jprob.A, max_iter=60, backend=backend)(jprob.b, jprob.x0)
    res = make_cg(prob.A, max_iter=60, backend=backend)(prob.b, prob.x0)
    jt, t = np.asarray(jres.trace), res.trace.numpy()
    assert t.dtype == jt.dtype
    head = jt > FLOOR[dtype] * jt[0]
    assert head[:15].all()
    if dtype == "float64":
        # identical recurrence; only the dots' summation order differs
        assert int(res.niters) == int(jres.niters) == 59
        np.testing.assert_allclose(t[head], jt[head], rtol=1e-10)
        np.testing.assert_allclose(res.x.numpy(), np.asarray(jres.x), rtol=1e-12)
    else:
        np.testing.assert_allclose(t[head], jt[head], rtol=1e-4)


@pytest.mark.parametrize("backend", BACKENDS)
def test_tolerance_early_exit_matches_jax(backend):
    """Exit semantics: the loop tests the normr of the previous body's top,
    so niters and the (one update stale) normr agree with JAX's while_loop."""
    jprob, prob = _jax_and_port((8, 8, 8), "float64")
    jres = jmake_cg(jprob.A, max_iter=500, tolerance=1e-10, backend=backend)(jprob.b, jprob.x0)
    res = make_cg(prob.A, max_iter=500, tolerance=1e-10, backend=backend)(prob.b, prob.x0)
    assert int(res.niters) == int(jres.niters) < 499
    np.testing.assert_allclose(float(res.normr), float(jres.normr), rtol=1e-6)
    np.testing.assert_allclose(float(res.rtrans), float(res.normr) ** 2, rtol=1e-12)
    trace = res.trace.numpy()
    assert np.isnan(trace[int(res.niters) + 1 :]).all()
    assert np.isfinite(trace[: int(res.niters) + 1]).all()


def test_check_every_does_not_change_the_result():
    """Launches after the exit (the host reads `active` only every few
    iterations) are no-ops."""
    prob = generate_problem(ProblemConfig(8, 8, 8), "cpu")
    for backend in ("pallas", "pallas_fused"):
        a = make_cg(prob.A, max_iter=500, tolerance=1e-10, backend=backend)(prob.b, prob.x0)
        b = make_cg(prob.A, max_iter=500, tolerance=1e-10, backend=backend, check_every=16)(prob.b, prob.x0)
        assert int(a.niters) == int(b.niters)
        assert torch.equal(a.x, b.x) and torch.equal(a.normr, b.normr)
        np.testing.assert_array_equal(a.trace.numpy(), b.trace.numpy())


def test_solver_config_and_backend_resolution():
    prob = generate_problem(ProblemConfig(4, 4, 4), "cpu")
    res = make_cg(prob.A, config=SolverConfig(max_iter=7))(prob.b, prob.x0)
    assert int(res.niters) == 6 and res.trace.shape == (7,)
    assert resolve_backend("auto", "cpu") == "stencil"
    assert resolve_backend("auto", "cuda") == "pallas_fused"
    with pytest.raises(ValueError):
        make_cg(prob.A, backend="ell")


def test_convert_round_trips():
    jprob, prob = _jax_and_port((6, 5, 4), "float64")
    back = problem_to_numpy(prob)
    for name in ("b", "x0", "xexact"):
        np.testing.assert_array_equal(back[name], np.asarray(getattr(jprob, name)))
    again = problem_from_numpy(**{k: back[k] for k in ("nx", "ny", "nz", "stencil", "b", "x0", "xexact")},
                               device="cpu")
    assert again.A == prob.A and torch.equal(again.b, prob.b)
    jres = jmake_cg(jprob.A, max_iter=20)(jprob.b, jprob.x0)
    res = result_from_numpy(np.asarray(jres.x), np.asarray(jres.niters), np.asarray(jres.normr),
                            np.asarray(jres.rtrans), np.asarray(jres.trace), device="cpu")
    out = result_to_numpy(res)
    for name in ("x", "niters", "normr", "rtrans", "trace"):
        np.testing.assert_array_equal(out[name], np.asarray(getattr(jres, name)))
    assert res.niters.dtype == torch.int32


def test_convert_round_trips_bf16():
    """A JAX bf16 problem and a JAX bf16 whole-solve result cross bit for
    bit: x in bf16, normr, rtrans and trace in their own float32."""
    from hpccg_tpu.ops.pallas.megakernel import cg_solve_mega

    jprob, prob = _jax_and_port((6, 5, 4), "bfloat16")
    assert prob.b.dtype == prob.x0.dtype == prob.xexact.dtype == torch.bfloat16
    back = problem_to_numpy(prob)
    for name in ("b", "x0", "xexact"):
        want = np.asarray(getattr(jprob, name))
        assert back[name].dtype == want.dtype
        np.testing.assert_array_equal(back[name].view(np.uint16), want.view(np.uint16))
    jres = cg_solve_mega(jprob.A, jprob.b, jprob.x0, max_iter=12)
    res = result_from_numpy(*(np.asarray(getattr(jres, k)) for k in ("x", "niters", "normr", "rtrans", "trace")),
                            device="cpu")
    assert res.x.dtype == torch.bfloat16 and res.niters.dtype == torch.int32
    assert res.normr.dtype == res.rtrans.dtype == res.trace.dtype == torch.float32
    out = result_to_numpy(res)
    for name in ("x", "niters", "normr", "rtrans", "trace"):
        want = np.asarray(getattr(jres, name))
        assert out[name].dtype == want.dtype
        np.testing.assert_array_equal(np.atleast_1d(out[name]).view(np.uint8), np.atleast_1d(want).view(np.uint8))
