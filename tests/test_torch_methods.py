"""The one-reduction CG methods (cg1, pipecg), residual replacement and
iterative refinement of the port against the JAX package, single device.

Both sides solve the very same system (the JAX problem carried across as
numpy). On the CPU the port's ``pallas`` / ``pallas_dd`` backends run K1's
and K7's plain versions; the JAX side runs its Pallas kernels in interpret
mode.

Tolerances, and why:

- cg1, float64: niters equal, trace rtol 1e-10 above 1e-11 * trace[0]
  (the same recurrence; the sums run in another order; measured 1.8e-13).
- pipecg, float64: niters equal, trace rtol 1e-6 above 1e-9 * trace[0].
  Its w = A r and z = A s recurrences carry each run's rounding forward, so
  two runs part faster than cg1's (measured 1.3e-7 at 12x10x9 on
  pallas_dd; the JAX package holds its own pipelined kernel to 1e-8 above
  1e-8).
- float32: trace rtol 1e-4 above 1e-5 * trace[0]; niters is not compared,
  since the f32 recurrence residual flushes to 0 at an iteration that
  depends on the rounding (see test_f32_cg1_flush_is_expected).
- pipecg over 150 iterations (test_pipecg_150_iterations_against_jax):
  float64 niters equal, trace rtol 1e-8 above 1e-7 * trace[0] (measured
  4.6e-10), x within 1e-9 of max|x| (measured 8.2e-11); float32 each side
  against its own float64 trajectory while that is above 1e-3 * trace[0]:
  the port within 1e-3 (measured 1.5e-4), the JAX package within 2e-2
  (measured 6.4e-3: its float32 dot products on the CPU are less exact).
  The test prints its readings (pytest -s).
"""

import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import hpccg_tpu  # noqa: E402
from hpccg_tpu.solver import cg_solve_refined as jcg_solve_refined  # noqa: E402
from hpccg_tpu.parallel import make_mesh as jmake_mesh  # noqa: E402
from hpccg_tpu.parallel.cg import generate_problem_sharded as jgenerate_sharded  # noqa: E402
from hpccg_tpu.parallel.cg import make_distributed_cg as jmake_distributed_cg  # noqa: E402
from hpccg_tpu.solver import make_cg as jmake_cg  # noqa: E402
from hpccg_tpu_torch import ProblemConfig, generate_problem, make_cg  # noqa: E402
from hpccg_tpu_torch.convert import dia_from_numpy, ell_from_numpy, problem_from_numpy, shards_to_numpy  # noqa: E402
from hpccg_tpu_torch.parallel import generate_problem_sharded, make_distributed_cg, make_mesh  # noqa: E402
from hpccg_tpu_torch.solver import cg_solve_refined  # noqa: E402

TRACE_TOL = {("cg1", "float64"): (1e-10, 1e-11), ("pipecg", "float64"): (1e-6, 1e-9),
             ("cg1", "float32"): (1e-4, 1e-5), ("pipecg", "float32"): (1e-3, 1e-4)}


def _problems(dims, dtype, stencil=27):
    jprob = hpccg_tpu.generate_problem(hpccg_tpu.ProblemConfig(*dims, stencil=stencil, dtype=getattr(jnp, dtype)))
    prob = problem_from_numpy(*dims, stencil, np.asarray(jprob.b), np.asarray(jprob.x0), np.asarray(jprob.xexact),
                              device="cpu")
    return jprob, prob


def _held(t, jt, method, dtype):
    rtol, floor = TRACE_TOL[(method, dtype)]
    head = np.isfinite(jt) & (jt > floor * jt[0])
    assert head[:5].all()
    np.testing.assert_allclose(t[head], jt[head], rtol=rtol)


@pytest.mark.parametrize("stencil", [27, 7])
@pytest.mark.parametrize("backend,dtype", [("stencil", "float64"), ("stencil", "float32"), ("pallas", "float64"),
                                           ("pallas", "float32"), ("pallas_dd", "float64")])
@pytest.mark.parametrize("method", ["cg1", "pipecg"])
def test_one_reduction_matches_jax(method, backend, dtype, stencil):
    jprob, prob = _problems((12, 10, 9), dtype, stencil)
    jres = jmake_cg(jprob.A, max_iter=40, backend=backend, method=method)(jprob.b, jprob.x0)
    res = make_cg(prob.A, max_iter=40, backend=backend, method=method)(prob.b, prob.x0)
    t, jt = res.trace.numpy(), np.asarray(jres.trace)
    assert t.dtype == jt.dtype and res.niters.dtype == torch.int32
    _held(t, jt, method, dtype)
    if dtype == "float64":
        assert int(res.niters) == int(jres.niters)
        np.testing.assert_allclose(res.x.numpy(), np.asarray(jres.x), rtol=1e-10)


@pytest.mark.parametrize("method", ["cg1", "pipecg"])
def test_tolerance_exit_is_delayed_as_in_jax(method):
    """The loop tests gamma_top, the r.r of the previous body's top: niters,
    normr and rtrans (= normr^2) agree with JAX's while_loop, and the trace
    is NaN past niters."""
    jprob, prob = _problems((8, 8, 8), "float64")
    jres = jmake_cg(jprob.A, max_iter=500, tolerance=1e-10, backend="stencil", method=method)(jprob.b, jprob.x0)
    res = make_cg(prob.A, max_iter=500, tolerance=1e-10, method=method)(prob.b, prob.x0)
    assert int(res.niters) == int(jres.niters) < 499
    rtol = 1e-6 if method == "cg1" else 1e-3  # pipecg: measured 6.1e-4 at 1.6e-11
    np.testing.assert_allclose(float(res.normr), float(jres.normr), rtol=rtol)
    np.testing.assert_allclose(float(res.rtrans), float(res.normr) ** 2, rtol=1e-12)
    trace = res.trace.numpy()
    assert np.isnan(trace[int(res.niters) + 1:]).all() and np.isfinite(trace[: int(res.niters) + 1]).all()


@pytest.mark.parametrize("method", ["cg1", "pipecg"])
def test_check_every_does_not_change_the_result(method):
    """Iterations launched after the exit (the host reads the flag only
    every few iterations) leave x and the scalars as they were."""
    _, prob = _problems((8, 8, 8), "float64")
    a = make_cg(prob.A, max_iter=500, tolerance=1e-10, method=method)(prob.b, prob.x0)
    b = make_cg(prob.A, max_iter=500, tolerance=1e-10, method=method, check_every=16)(prob.b, prob.x0)
    assert int(a.niters) == int(b.niters) and torch.equal(a.x, b.x) and torch.equal(a.normr, b.normr)
    np.testing.assert_array_equal(a.trace.numpy(), b.trace.numpy())


@pytest.mark.parametrize("method", ["cg1", "pipecg"])
@pytest.mark.parametrize("backend", ["stencil", "pallas"])
def test_replace_every_matches_jax(method, backend):
    """Residual replacement every 7 iterations: JAX's trajectory, and in
    float64 the plain cg trajectory above the floor (in exact arithmetic
    replacement changes nothing)."""
    jprob, prob = _problems((12, 10, 9), "float64")
    kw = dict(max_iter=500, tolerance=1e-10, replace_every=7)
    jres = jmake_cg(jprob.A, backend=backend, method=method, **kw)(jprob.b, jprob.x0)
    res = make_cg(prob.A, backend=backend, method=method, **kw)(prob.b, prob.x0)
    assert int(res.niters) == int(jres.niters) < 499
    _held(res.trace.numpy(), np.asarray(jres.trace), "pipecg", "float64")
    cg = make_cg(prob.A, max_iter=500, tolerance=1e-10, backend=backend)(prob.b, prob.x0)
    assert int(cg.niters) == int(res.niters)
    _held(res.trace.numpy(), cg.trace.numpy(), "pipecg", "float64")


def test_f32_cg1_flush_is_expected():
    """In float32 the cg1 recurrence residual decays below the true
    residual's floor and flushes to exact 0, which ends a tolerance-0 run
    early on both sides (at iterations that depend on the rounding: 52 in
    JAX and 61 here at 12x10x9, ~140 at 100^3). Not flagged: normr is 0 and
    the trace finite up to niters. Where r.u flushes to 0 with r.r, alpha is
    0/0 and the delayed exit check turns x to NaN one iteration later: the
    exact-convergence quirk of the recurrence, kept from the JAX package
    (collective_kernel.py:185-190); here r.u flushes with r.r (JAX's r.u
    keeps a denormal and its x stays finite). Replacement every 50
    iterations keeps the run going to max_iter with a finite x."""
    jprob, prob = _problems((12, 10, 9), "float32")
    jres = jmake_cg(jprob.A, max_iter=300, backend="stencil", method="cg1")(jprob.b, jprob.x0)
    res = make_cg(prob.A, max_iter=300, method="cg1")(prob.b, prob.x0)
    assert int(jres.niters) < 299 and int(res.niters) < 299
    assert float(res.normr) == 0.0 == float(jres.normr)
    assert np.isfinite(res.trace.numpy()[: int(res.niters) + 1]).all()
    assert bool(torch.isnan(res.x).all()) or float((res.x - 1).abs().max()) < 1e-4
    replaced = make_cg(prob.A, max_iter=300, method="cg1", replace_every=50)(prob.b, prob.x0)
    assert int(replaced.niters) == 299 and float(replaced.normr) > 0
    assert float((replaced.x - 1).abs().max()) < 1e-4


def _pipecg_150(ndev, dims, dtype):
    """(port result, JAX result, port problem) of pipecg over 150
    iterations on ndev ranks of dims each, tolerance 0."""
    jcfg = hpccg_tpu.ProblemConfig(*dims, dtype=getattr(jnp, dtype))
    jmesh = jmake_mesh(ndev)
    jprob = jgenerate_sharded(jcfg, jmesh)
    jres = jmake_distributed_cg(jcfg, jmesh, max_iter=150, backend="stencil", method="pipecg")(jprob.b, jprob.x0)
    cfg = ProblemConfig(*dims, dtype=getattr(torch, dtype))
    mesh = make_mesh(ndev, devices=["cpu"] * ndev)
    prob = generate_problem_sharded(cfg, mesh)
    res = make_distributed_cg(cfg, mesh, max_iter=150, backend="stencil", method="pipecg")(prob.b, prob.x0)
    return res, jres, prob


@pytest.mark.parametrize("ndev,dims", [(1, (64, 64, 64)), (4, (32, 32, 32))])
def test_pipecg_150_iterations_against_jax(ndev, dims):
    """pipecg over the main path's 150 iterations, on the weak-scaling
    block and on four ranks. float64: the port's plain version is the JAX
    package's recurrence (niters, trace, x). float32, on both sides: the
    trace follows the float64 trajectory while that is above 1e-3 of
    trace[0], then stagnates (near 1e-6..1e-5 of trace[0]) where float64
    decays below 1e-10; x stays finite but loses the accuracy cg reaches
    (true residual above 1e-5 of ||b|| on both sides, against cg's 1.5e-6):
    Ghysels-Vanroose's recurrences carry each run's rounding forward."""
    r64, j64, _ = _pipecg_150(ndev, dims, "float64")
    r32, j32, prob = _pipecg_150(ndev, dims, "float32")
    t64, jt64 = r64.trace.numpy(), np.asarray(j64.trace)
    assert int(r64.niters) == int(j64.niters) == 149
    above = jt64 > 1e-7 * jt64[0]
    np.testing.assert_allclose(t64[above], jt64[above], rtol=1e-8)
    x64, jx64 = shards_to_numpy(r64.x), np.asarray(j64.x)
    assert np.abs(x64 - jx64).max() <= 1e-9 * np.abs(jx64).max()
    head = t64 > 1e-3 * t64[0]
    assert 15 < head.sum() < 40
    np.testing.assert_allclose(r32.trace.numpy()[head], t64[head], rtol=1e-3)
    np.testing.assert_allclose(np.asarray(j32.trace)[head], jt64[head], rtol=2e-2)
    for t in (t64, jt64):
        assert t[100:].max() < 1e-10 * t[0]
    b = torch.cat([v.double() for v in prob.b])
    A = generate_problem(ProblemConfig(dims[0], dims[1], dims[2] * ndev, dtype=torch.float64), "cpu").A
    accuracy = {}
    for side, t, x in (("port", r32.trace.numpy(), shards_to_numpy(r32.x)),
                       ("jax", np.asarray(j32.trace), np.asarray(j32.x))):
        assert np.isfinite(t).all() and t[100:].min() > 1e-7 * t[0]
        x = torch.from_numpy(x.astype(np.float64))
        assert bool(torch.isfinite(x).all())
        accuracy[side] = float((b - A.matvec(x)).norm() / b.norm())
    head_dev = {"port": float(np.abs(r32.trace.numpy()[head] / t64[head] - 1).max()),
                "jax": float(np.abs(np.asarray(j32.trace)[head] / jt64[head] - 1).max())}
    print(f"pipecg, {ndev} x {dims}: f64 trace {np.abs(t64[above] / jt64[above] - 1).max():.2e} and x "
          f"{np.abs(x64 - jx64).max() / np.abs(jx64).max():.2e} from JAX's; f32 trace from its f64 one over "
          f"the head {head_dev}; f32 true residual / ||b|| {accuracy}")
    assert min(accuracy.values()) > 1e-5


def test_f32_pipecg_accuracy_follows_the_rounding():
    """The port's plain float32 pipecg at 64^3, 150 iterations, with 1-4
    CPU threads: the thread count changes only the order of the dot
    products' sums. The traces agree while the stencil residual is above
    1e-3 of trace[0] and stagnate after; the true residuals of x scatter
    (1.3e-4 to 7.9e-1 of ||b|| on one machine; printed with -s), so no
    limit on float32 pipecg's x is backed by its reference."""
    cfg = ProblemConfig(64, 64, 64, dtype=torch.float32)
    prob = generate_problem(cfg, "cpu")
    p64 = generate_problem(ProblemConfig(64, 64, 64, dtype=torch.float64), "cpu")
    ref = make_cg(p64.A, max_iter=150, method="pipecg")(p64.b, p64.x0).trace.numpy()
    head = ref > 1e-3 * ref[0]
    threads = torch.get_num_threads()
    accuracy = {}
    try:
        for n in (1, 2, 3, 4):
            torch.set_num_threads(n)
            res = make_cg(prob.A, max_iter=150, method="pipecg")(prob.b, prob.x0)
            t = res.trace.numpy()
            np.testing.assert_allclose(t[head], ref[head], rtol=1e-3)
            assert t[100:].min() > 1e-7 * t[0] and bool(torch.isfinite(res.x).all())
            x = res.x.double()
            accuracy[n] = float((p64.b - p64.A.matvec(x)).norm() / p64.b.norm())
    finally:
        torch.set_num_threads(threads)
    print(f"float32 pipecg at 64^3, true residual / ||b|| by thread count: {accuracy}")
    assert min(accuracy.values()) > 1e-5


def test_refined_matches_jax():
    """float32 inner solves, float64 outer rounds: the outer residuals fall
    by orders of magnitude per round on both sides (the f32 inner solves
    stop at a relative 1e-6 after a number of iterations that depends on
    their rounding, so the rounds agree in order of magnitude, not digits);
    trace[0] and the final f64 accuracy agree."""
    jprob, prob = _problems((12, 10, 9), "float64")
    jres = jcg_solve_refined(jprob.A, jprob.b, jprob.x0, inner_max_iter=60, outer_max_iter=3, backend="stencil")
    res = cg_solve_refined(prob.A, prob.b, prob.x0, inner_max_iter=60, outer_max_iter=3, backend="stencil")
    t, jt = res.trace.numpy(), np.asarray(jres.trace)
    assert t.shape == jt.shape == (4,) and res.x.dtype == torch.float64
    np.testing.assert_allclose(t[0], jt[0], rtol=1e-14)
    assert np.all(np.abs(np.log10(t[1:]) - np.log10(jt[1:])) < 1.0)
    assert float(res.normr) < 1e-12 * t[0] and abs(int(res.niters) - int(jres.niters)) <= 6
    assert float((res.x - 1).abs().max()) < 1e-12
    with pytest.raises(ValueError, match="float64"):
        cg_solve_refined(prob.A, prob.b.float(), prob.x0.float())


@pytest.mark.parametrize("method", ["cg1", "pipecg"])
@pytest.mark.parametrize("fmt", ["ell", "dia"])
def test_explicit_matrices_run_one_reduction_methods(fmt, method):
    """cg1/pipecg on the explicit ELL and DIA matrices (the matrix's kernel,
    K9/K11's plain versions here) against JAX's on its own matrices."""
    from hpccg_tpu.models.stencil import generate_ell as jgenerate_ell

    jprob = jgenerate_ell(hpccg_tpu.ProblemConfig(12, 10, 9))
    jA = jprob.A if fmt == "ell" else jprob.A.to_dia()
    if fmt == "ell":
        A = ell_from_numpy(jA.vals, jA.cols, jA.valid, jA.start_row, jA.total_nrow, device="cpu")
    else:
        A = dia_from_numpy(jA.data, jA.offsets, jA.total_nrow, device="cpu")
    b, x0 = (torch.from_numpy(np.asarray(v).copy()) for v in (jprob.b, jprob.x0))
    jres = jmake_cg(jA, max_iter=40, method=method)(jprob.b, jprob.x0)
    res = make_cg(A, max_iter=40, method=method)(b, x0)
    assert int(res.niters) == int(jres.niters) == 39
    _held(res.trace.numpy(), np.asarray(jres.trace), method, "float64")


def test_method_dispatch_warns_and_refuses():
    """The whole-solve and fused backends run the reference recurrence only:
    a one-reduction method warns and runs pallas, as JAX does; an unknown
    method raises; bfloat16 on a kernel backend raises."""
    _, prob = _problems((6, 5, 4), "float64")
    ref = make_cg(prob.A, max_iter=20, backend="pallas", method="cg1")(prob.b, prob.x0)
    for backend in ("megakernel", "streamkernel", "pallas_fused"):
        with pytest.warns(UserWarning, match="implements method='cg' only"):
            solve = make_cg(prob.A, max_iter=20, backend=backend, method="cg1")
        assert torch.equal(solve(prob.b, prob.x0).trace, ref.trace)
    with pytest.raises(ValueError, match="unknown CG method"):
        make_cg(prob.A, method="bicg")
    _, bf = _problems((6, 5, 4), "bfloat16")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with pytest.raises(ValueError, match="bfloat16"):
            make_cg(bf.A, backend="pallas_fused", method="pipecg")
