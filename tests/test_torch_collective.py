"""The plain versions of the collective whole-solve kernels, K15 (methods cg
and cg1) and K16 (pipecg), against the JAX package's collective Pallas
kernels, on the CPU.

At ndev 1 and 2 the JAX kernels run as ``tests/test_collective.py`` runs
them: interpret mode (with in-kernel remote copies between the virtual
devices), through ``make_distributed_cg(backend="collective")``; that takes
1-5 s a call here, so these cases use small blocks (6x5x4 for 25
iterations at ndev 1, 4x3x2 for 12 at ndev 2). At ndev 4, 6 and 8 the
reference is JAX's shard_map tier with the same method, which
``tests/test_collective.py`` holds equal to the kernels to 1e-9.

Tolerances (float64): niters equal; trace rtol 1e-10 above 1e-11 *
trace[0] for cg and cg1, 1e-6 above 1e-9 for pipecg (its w/z recurrences
carry each run's rounding forward; tests/test_torch_methods.py); x within
1e-10 (pipecg 1e-8).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import hpccg_tpu  # noqa: E402
from hpccg_tpu.parallel import make_mesh as jmake_mesh  # noqa: E402
from hpccg_tpu.parallel.cg import generate_problem_sharded as jgenerate_sharded  # noqa: E402
from hpccg_tpu.parallel.cg import make_distributed_cg as jmake_distributed_cg  # noqa: E402
from hpccg_tpu_torch import ProblemConfig  # noqa: E402
from hpccg_tpu_torch.convert import shards_to_numpy  # noqa: E402
from hpccg_tpu_torch.operators import StencilOperator  # noqa: E402
from hpccg_tpu_torch.ops.cuda import collective as col  # noqa: E402
from hpccg_tpu_torch.parallel import generate_problem_sharded, make_mesh  # noqa: E402

TOL = {"cg": (1e-10, 1e-11, 1e-10), "cg1": (1e-10, 1e-11, 1e-10), "pipecg": (1e-6, 1e-9, 1e-8)}


def _port(dims, ndev, method, max_iter):
    prob = generate_problem_sharded(ProblemConfig(*dims), make_mesh(ndev, devices=["cpu"] * ndev))
    op = StencilOperator(*dims)
    before = (col.cg_collective.launches, col.cg_collective_pipelined.launches)
    if method == "pipecg":
        res = col.cg_collective_pipelined(op, prob.b, prob.x0, max_iter=max_iter)
    else:
        res = col.cg_collective(op, prob.b, prob.x0, method=method, max_iter=max_iter)
    assert (col.cg_collective.launches, col.cg_collective_pipelined.launches) == before  # plain: no launch
    return res


def _jax(dims, ndev, method, max_iter, backend):
    cfg = hpccg_tpu.ProblemConfig(*dims)
    mesh = jmake_mesh(ndev)
    prob = jgenerate_sharded(cfg, mesh)
    return jmake_distributed_cg(cfg, mesh, max_iter=max_iter, backend=backend, method=method)(prob.b, prob.x0)


def _held(res, jres, method):
    rtol, floor, xtol = TOL[method]
    jt = np.asarray(jres.trace)
    head = np.isfinite(jt) & (jt > floor * jt[0])
    assert head[:5].all()
    assert int(res.niters) == int(jres.niters)
    np.testing.assert_allclose(res.trace.numpy()[head], jt[head], rtol=rtol)
    np.testing.assert_allclose(shards_to_numpy(res.x), np.asarray(jres.x), rtol=xtol)
    np.testing.assert_allclose(float(res.normr) ** 2, float(res.rtrans), rtol=1e-12)


@pytest.mark.parametrize("method", ["cg", "cg1", "pipecg"])
@pytest.mark.parametrize("ndev,dims,max_iter", [(1, (6, 5, 4), 25), (2, (4, 3, 2), 12)])
def test_plain_matches_jax_collective_kernels(ndev, dims, max_iter, method):
    res = _port(dims, ndev, method, max_iter)
    _held(res, _jax(dims, ndev, method, max_iter, "collective"), method)
    assert int(res.niters) == max_iter - 1


@pytest.mark.parametrize("method", ["cg", "cg1", "pipecg"])
@pytest.mark.parametrize("ndev", [4, 6, 8])
def test_plain_matches_jax_shard_map_tier(ndev, method):
    res = _port((6, 5, 4), ndev, method, 30)
    _held(res, _jax((6, 5, 4), ndev, method, 30, "stencil"), method)


@pytest.mark.parametrize("method", ["cg", "cg1", "pipecg"])
def test_tolerance_exit_matches_jax(method):
    """The exit of a tolerance run: cg tests the normr of its last top,
    cg1/pipecg gamma_top (one update older), as the JAX kernels do."""
    cfg = hpccg_tpu.ProblemConfig(5, 4, 3)
    mesh = jmake_mesh(4)
    jprob = jgenerate_sharded(cfg, mesh)
    jres = jmake_distributed_cg(cfg, mesh, max_iter=200, tolerance=1e-10, method=method)(jprob.b, jprob.x0)
    prob = generate_problem_sharded(ProblemConfig(5, 4, 3), make_mesh(4, devices=["cpu"] * 4))
    op = StencilOperator(5, 4, 3)
    kern = col.cg_collective_pipelined if method == "pipecg" else col.cg_collective
    kw = {} if method == "pipecg" else {"method": method}
    res = kern(op, prob.b, prob.x0, max_iter=200, tolerance=1e-10, **kw)
    assert int(res.niters) == int(jres.niters) < 199
    np.testing.assert_allclose(float(res.normr), float(jres.normr), rtol=1e-6 if method != "pipecg" else 1e-3)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    mesh = make_mesh(2, devices=["cpu"] * 2)
    prob = generate_problem_sharded(ProblemConfig(4, 3, 2), mesh)
    op = StencilOperator(4, 3, 2)
    with pytest.raises(ValueError, match="pipecg is K16"):
        col.cg_collective(op, prob.b, prob.x0, method="pipecg", max_iter=5)
    half = tuple(v.to(torch.float16) for v in prob.b)  # bfloat16 has an instance; float16 none
    with pytest.raises(TypeError, match="bfloat16"):
        col.cg_collective(op, half, tuple(v.clone() for v in half), max_iter=5)
    with pytest.raises(TypeError):
        col.cg_collective_pipelined(op, tuple(v.int() for v in prob.b), prob.x0, max_iter=5)
    with pytest.raises(ValueError, match="contiguous"):
        col.cg_collective(op, (prob.b[0][:-1], prob.b[1]), prob.x0, max_iter=5)
    with pytest.raises(ValueError, match="shards"):
        col.cg_collective(op, prob.b[:1], prob.x0, max_iter=5)
    with pytest.raises(ValueError, match="alias"):
        col.cg_collective(op, prob.b, prob.b, max_iter=5)
