"""The plain versions of the collective whole-solve kernels K15 (cg, cg1)
and K16 (pipecg) in bfloat16 against the JAX package's collective Pallas
kernels in bfloat16, on the CPU.

The JAX kernels run bf16 through ``make_distributed_cg(backend=
"collective")`` (no dtype gate; vectors, alpha/beta and the allreduce rows
in bf16, the trace in float32), in interpret mode as
``tests/test_torch_collective.py`` runs them: 6x5x4 for 25 iterations at
ndev 1, 4x3x2 for 12 at ndev 2. At ndev 4 the reference is JAX's shard_map
tier in bf16 (all-bf16 scalars). The port's bf16 instance keeps float32
scalars, partials and trace (``config.scalar_dtype``), so the two
recurrences round at other places and are held with JAX's own bf16
tolerances: niters equal, the trace within rtol 0.15 where it is above
0.05 * trace[0], and for cg and cg1 max|x_port - x_jax| <= 0.08 (x solves
to ones; JAX's bf16 cg/cg1 x lies within 0.0078 of them here). pipecg's
bf16 x lies 0.14-1.3 from ones in JAX and in the port at these sizes (its
w and z recurrences carry the bf16 rounding forward, and JAX's trace
climbs back to 19.9 after 7.5 at ndev 1 where the port's goes on to
0.92), so only its trace head, k <= 3, is compared.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import hpccg_tpu  # noqa: E402
from hpccg_tpu.parallel import make_mesh as jmake_mesh  # noqa: E402
from hpccg_tpu.parallel.cg import generate_problem_sharded as jgenerate_sharded  # noqa: E402
from hpccg_tpu.parallel.cg import make_distributed_cg as jmake_distributed_cg  # noqa: E402
from hpccg_tpu_torch import ProblemConfig  # noqa: E402
from hpccg_tpu_torch.convert import shards_to_numpy  # noqa: E402
from hpccg_tpu_torch.operators import StencilOperator  # noqa: E402
from hpccg_tpu_torch.ops.cuda import collective as col  # noqa: E402
from hpccg_tpu_torch.ops.cuda.wholesolve import plane_dot  # noqa: E402
from hpccg_tpu_torch.parallel import generate_problem_sharded, make_distributed_cg, make_mesh  # noqa: E402
from hpccg_tpu_torch.parallel.halo import stencil_matvec_halo  # noqa: E402

TRACE_RTOL, TRACE_FLOOR, X_ATOL = 0.15, 0.05, 0.08
PIPECG_HEAD = 4  # trace entries k = 0..3


def _port(dims, ndev, method, max_iter):
    prob = generate_problem_sharded(ProblemConfig(*dims, dtype=torch.bfloat16), make_mesh(ndev, devices=["cpu"] * ndev))
    op = StencilOperator(*dims, dtype=torch.bfloat16)
    before = (col.cg_collective.launches_bf16, col.cg_collective_pipelined.launches_bf16)
    if method == "pipecg":
        res = col.cg_collective_pipelined(op, prob.b, prob.x0, max_iter=max_iter)
    else:
        res = col.cg_collective(op, prob.b, prob.x0, method=method, max_iter=max_iter)
    assert (col.cg_collective.launches_bf16, col.cg_collective_pipelined.launches_bf16) == before  # plain: no launch
    assert res.x[0].dtype == torch.bfloat16 and res.trace.dtype == torch.float32
    return res


def _jax(dims, ndev, method, max_iter, backend):
    cfg = hpccg_tpu.ProblemConfig(*dims, dtype=jnp.bfloat16)
    mesh = jmake_mesh(ndev)
    prob = jgenerate_sharded(cfg, mesh)
    return jmake_distributed_cg(cfg, mesh, max_iter=max_iter, backend=backend, method=method)(prob.b, prob.x0)


def _held(res, jres, method):
    jt = np.asarray(jres.trace, dtype=np.float64)
    head = np.isfinite(jt) & (jt > TRACE_FLOOR * jt[0])
    assert head[:3].all()
    if method == "pipecg":
        head[PIPECG_HEAD:] = False
    assert int(res.niters) == int(jres.niters)
    np.testing.assert_allclose(res.trace.double().numpy()[head], jt[head], rtol=TRACE_RTOL)
    if method != "pipecg":
        x, jx = shards_to_numpy(res.x).astype(np.float64), np.asarray(jres.x).astype(np.float64)
        assert np.abs(x - jx).max() <= X_ATOL


@pytest.mark.parametrize("method", ["cg", "cg1", "pipecg"])
@pytest.mark.parametrize("ndev,dims,max_iter", [(1, (6, 5, 4), 25), (2, (4, 3, 2), 12)])
def test_plain_bf16_matches_jax_collective_kernels(ndev, dims, max_iter, method):
    res = _port(dims, ndev, method, max_iter)
    _held(res, _jax(dims, ndev, method, max_iter, "collective"), method)
    assert int(res.niters) == max_iter - 1


@pytest.mark.parametrize("method", ["cg", "cg1", "pipecg"])
def test_plain_bf16_matches_jax_shard_map_tier(method):
    res = _port((6, 5, 4), 4, method, 30)
    _held(res, _jax((6, 5, 4), 4, method, 30, "stencil"), method)


@pytest.mark.parametrize("method", ["cg", "cg1", "pipecg"])
def test_bf16_split_rounds_where_the_kernel_stores(method):
    """The plain bf16 version against the same recurrence computed on
    float32 vectors: the first iterations agree to bf16's precision (the
    rounding points only add bf16 roundings), and through
    make_distributed_cg(backend="collective") it is what runs on the CPU."""
    dims, ndev = (6, 5, 4), 2
    mesh = make_mesh(ndev, devices=["cpu"] * ndev)
    cfg = ProblemConfig(*dims, dtype=torch.bfloat16)
    prob = generate_problem_sharded(cfg, mesh)
    res = make_distributed_cg(cfg, mesh, max_iter=20, backend="collective", method=method)(prob.b, prob.x0)
    direct = _port(dims, ndev, method, 20)
    assert torch.equal(res.trace, direct.trace)
    assert all(torch.equal(a, b) for a, b in zip(res.x, direct.x))
    op32 = StencilOperator(*dims, dtype=torch.float32)
    f32 = col.solve_plain(op32, tuple(v.float() for v in prob.b), tuple(v.float() for v in prob.x0), method=method,
                          max_iter=20)
    # trace[0] sums the bf16-rounded r = b - A x0: exact here (integer values)
    assert float(res.trace[0]) == float(f32.trace[0])
    np.testing.assert_allclose(res.trace[:4].numpy(), f32.trace[:4].numpy(), rtol=2e-2)


@pytest.mark.parametrize("method", ["cg", "cg1", "pipecg"])
def test_bf16_plain_dots_are_plane_dots_in_rank_order(method, monkeypatch):
    """The plain bf16 version sums every dot as K15/K16 do (rank_dot): each
    rank's wholesolve.plane_dot (a z-plane's products added in float64 and
    rounded to float32 once, the plane sums added in float32 in z order),
    the ranks' values added in float32 in rank order. Each of its dots on 4
    ranks is that fold, and trace[0] is the root of r.r for r = b - A x0
    rounded to bf16."""
    dims, ndev, iters = (6, 5, 4), 4, 10
    real, seen = col.rank_dot, []

    def fold(us, vs, nz, sdt):
        got = real(us, vs, nz, sdt)
        want = None
        for u, v in zip(us, vs):
            part = plane_dot(u, v, nz, sdt)
            want = part if want is None else want + part
        assert nz == dims[2] and sdt == torch.float32 and len(us) == ndev
        assert torch.equal(got, want)
        seen.append(got)
        return got

    monkeypatch.setattr(col, "rank_dot", fold)
    res = _port(dims, ndev, method, iters)
    assert int(res.niters) == iters - 1 and len(seen) >= 2 * (iters - 1)
    prob = generate_problem_sharded(ProblemConfig(*dims, dtype=torch.bfloat16), make_mesh(ndev, devices=["cpu"] * ndev))
    op32 = StencilOperator(*dims, dtype=torch.float32)
    r = tuple((b.float() - y).to(torch.bfloat16)
              for b, y in zip(prob.b, stencil_matvec_halo(op32, tuple(x.float() for x in prob.x0))))
    assert float(res.trace[0]) == float(torch.sqrt(real(r, r, dims[2], torch.float32)[0]))
