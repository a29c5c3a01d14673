"""K4s, the stencil CG update that recomputes Ap' from p', and K3 without its
Ap' store, on the CPU.

One device's ``pallas_fused`` solve runs K3 without storing Ap' and then
K4s (``ops.cuda.stencil.update_x_r_stencil``: x += alpha p', r -= alpha A p',
partials of the new r . r) in place of K3 with Ap' and K4. Here the plain
versions, which the wrappers run on the CPU, are held against that K3 + K4
sequence bit for bit (x, r, p' and the partials, in every dtype: A p' is
rounded to the vectors' dtype as K3 stores it) on grids at the edges of
the CUDA kernels' tile (the kinds of ``test_torch_cuda.py``'s ``EDGES``),
with ``active`` = 0 and on views at element offsets; the solve against
JAX's ``pallas_fused`` solve, against the K3 + K4 route of the same
function and against the reference's golden 10^3 run.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import hpccg_tpu  # noqa: E402
from hpccg_tpu.solver import make_cg as jmake_cg  # noqa: E402
from hpccg_tpu_torch import ProblemConfig, generate_problem, make_cg  # noqa: E402
from hpccg_tpu_torch.config import Stencil, scalar_dtype  # noqa: E402
from hpccg_tpu_torch.convert import problem_from_numpy  # noqa: E402
from hpccg_tpu_torch.operators import StencilOperator  # noqa: E402
from hpccg_tpu_torch.ops.cuda import fused_cg as fc  # noqa: E402
from hpccg_tpu_torch.ops.cuda import stencil as st  # noqa: E402
from hpccg_tpu_torch.solver import cg_solve_fused  # noqa: E402

from oracle import GOLDEN_10_NITERS, GOLDEN_10_TRACE  # noqa: E402

DTYPES = [torch.float64, torch.float32, torch.bfloat16]
EDGES = ["nx<V", "nx=100", "nx=TX-1", "nx=TX+1", "ny%TY", "nz<ZC", "nz=ZC+1"]
BETA, ALPHA = 0.375, 0.1875  # exact in bf16


def _edge_shape(edge, dtype):
    """(nx, ny, nz) at ``edge`` of the CUDA stencil tile for ``dtype``: V =
    16 bytes of points a thread, TX = 32 V, TY = 8 rows, ZC = 32 z-planes
    a block at most (``test_torch_cuda._edge_shape`` asks the card's
    library for the same constants)."""
    v = 16 // dtype.itemsize
    tx, ty, zc = 32 * v, 8, 32
    return {"nx<V": (max(v - 1, 1), ty + 3, 5), "nx=100": (100, ty + 3, 7), "nx=TX-1": (tx - 1, ty + 1, 6),
            "nx=TX+1": (tx + 1, 2 * ty + 1, 5), "ny%TY": (33, 3 * ty + 5, 9), "nz<ZC": (tx + 1, 2 * ty + 1, zc - 1),
            "nz=ZC+1": (tx + 1, 2 * ty + 1, zc + 1)}[edge]


def _vectors(n, dtype, seed, k=4):
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn((n,), generator=gen, dtype=torch.float64).to(dtype) for _ in range(k)]


def _both_routes(op, x, r, p, beta, alpha, active=None):
    """One CG iteration's two passes both ways on copies of (x, r, p): K3
    with Ap' then K4, and K3 without Ap' then K4s. Returns each route's
    (p', x, r, K3 partials, update partials)."""
    routes = []
    for recompute in (False, True):
        xs, rs = x.clone(), r.clone()
        pp, ap, part3 = st.update_p_apply(op, rs, p, beta, active=active, store_ap=not recompute)
        if recompute:
            assert ap is None
            _, _, part4 = st.update_x_r_stencil(op, xs, rs, pp, alpha, active=active)
        else:
            _, _, part4 = fc.update_x_r(xs, rs, pp, ap, alpha, active=active)
        routes.append((pp, xs, rs, part3, part4))
    return routes


def _same(a, b):
    assert all(torch.equal(u, v) for u, v in zip(a, b))


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: str(d)[6:])
@pytest.mark.parametrize("stencil", [27, 7])
@pytest.mark.parametrize("edge", EDGES)
def test_k4s_plain_matches_k3_then_k4(edge, stencil, dtype):
    """K3 without Ap' and K4s against K3 with Ap' and K4, bit for bit."""
    nx, ny, nz = _edge_shape(edge, dtype)
    op = StencilOperator(nx, ny, nz, Stencil(stencil), dtype)
    x, r, p, _ = (v.view(nz, ny, nx) for v in _vectors(nx * ny * nz, dtype, nx * 1000 + nz))
    sdt = scalar_dtype(dtype)
    beta, alpha = torch.tensor([BETA], dtype=sdt), torch.tensor([ALPHA], dtype=sdt)
    kept, recomputed = _both_routes(op, x, r, p, beta, alpha)
    _same(kept, recomputed)
    assert not torch.equal(recomputed[1], x) and not torch.equal(recomputed[2], r)
    assert recomputed[4].dtype == sdt and recomputed[4].shape == (1,)


def test_k4s_inactive_is_a_no_op():
    """``active`` = 0: K4s writes neither x, r nor its partials, and K3
    without Ap' writes neither p' nor its partials."""
    op = StencilOperator(9, 5, 7)
    x, r, p, u = (v.view(7, 5, 9) for v in _vectors(9 * 5 * 7, torch.float64, 3))
    off = torch.zeros((1,), dtype=torch.int32)
    xs, rs = x.clone(), r.clone()
    parts = torch.full((1,), 5.0, dtype=torch.float64)
    st.update_x_r_stencil(op, xs, rs, p, torch.ones(1, dtype=torch.float64), partials=parts, active=off)
    assert torch.equal(xs, x) and torch.equal(rs, r) and float(parts) == 5.0
    out = torch.full_like(u, 7.0)
    pp, ap, parts = st.update_p_apply(op, r, p, torch.ones(1, dtype=torch.float64), out_p=out, partials=parts,
                                      active=off, store_ap=False)
    assert pp is out and ap is None and bool((out == 7.0).all()) and float(parts) == 5.0
    on = torch.ones((1,), dtype=torch.int32)
    _same(*_both_routes(op, x, r, p, torch.tensor([BETA], dtype=torch.float64),
                        torch.tensor([ALPHA], dtype=torch.float64), active=on))


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: str(d)[6:])
def test_k4s_on_views_at_an_element_offset(dtype):
    """x, r and p' as views at odd element offsets into their storage: the
    same bits as K3 + K4 on contiguous copies."""
    nx, ny, nz = 100, 9, 7
    n = nx * ny * nz
    op = StencilOperator(nx, ny, nz, Stencil.S27, dtype)
    views = [v[off:off + n].view(nz, ny, nx) for v, off in zip(_vectors(n + 5, dtype, 5, k=3), (1, 3, 5))]
    assert [v.storage_offset() for v in views] == [1, 3, 5]
    sdt = scalar_dtype(dtype)
    beta, alpha = torch.tensor([BETA], dtype=sdt), torch.tensor([ALPHA], dtype=sdt)
    kept = _both_routes(op, *(v.clone() for v in views), beta, alpha)[0]
    x, r, p = views
    pp = torch.empty((n + 3,), dtype=dtype)[3:].view(nz, ny, nx)
    st.update_p_apply(op, r, p, beta, out_p=pp, store_ap=False)
    _, _, part4 = st.update_x_r_stencil(op, x, r, pp, alpha)
    _same(kept, (pp, x, r, kept[3], part4))


def test_k4s_refuses_what_its_kernel_does_not_take():
    op = StencilOperator(4, 4, 4)
    g = torch.zeros((4, 4, 4), dtype=torch.float64)
    one = torch.ones(1, dtype=torch.float64)
    with pytest.raises(ValueError, match="alias"):
        st.update_x_r_stencil(op, g, g.clone(), g, one)
    with pytest.raises(ValueError, match="shape"):
        st.update_x_r_stencil(op, g.reshape(-1), g.clone(), g.clone(), one)
    with pytest.raises(ValueError, match="store_ap"):
        st.update_p_apply(op, g, g.clone(), one, out_ap=g.clone(), store_ap=False)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_fused_solve_matches_jax_and_the_k4_route(dtype):
    """One device's pallas_fused solve (K3 without Ap', K4s) against JAX's
    pallas_fused solve of the same system, and bit for bit against the K3 +
    K4 route of ``cg_solve_fused`` (taken when ``halo4`` is given)."""
    nx, ny, nz = 12, 10, 9
    jprob = hpccg_tpu.generate_problem(hpccg_tpu.ProblemConfig(nx, ny, nz, dtype=getattr(jnp, dtype)))
    prob = problem_from_numpy(nx, ny, nz, 27, np.asarray(jprob.b), np.asarray(jprob.x0), np.asarray(jprob.xexact),
                              device="cpu")
    jres = jmake_cg(jprob.A, max_iter=60, backend="pallas_fused")(jprob.b, jprob.x0)
    res = make_cg(prob.A, max_iter=60, backend="pallas_fused")(prob.b, prob.x0)
    jt, t = np.asarray(jres.trace), res.trace.numpy()
    floor, rtol = (1e-11, 1e-10) if dtype == "float64" else (1e-5, 1e-4)
    head = jt > floor * jt[0]
    assert head[:15].all() and int(res.niters) == int(jres.niters) == 59
    np.testing.assert_allclose(t[head], jt[head], rtol=rtol)
    if dtype == "float64":
        np.testing.assert_allclose(res.x.numpy(), np.asarray(jres.x), rtol=1e-12)
    k4 = cg_solve_fused(prob.A, prob.b, prob.x0, max_iter=60, halo4=lambda rs, ps: [None])
    assert int(k4.niters) == int(res.niters)
    assert torch.equal(k4.x, res.x) and torch.equal(k4.normr, res.normr)
    np.testing.assert_array_equal(k4.trace.numpy(), t)


def test_fused_solve_golden_10():
    """The reference's checked-in run on pallas_fused: 10^3, float64,
    max_iter 150, 149 iterations."""
    prob = generate_problem(ProblemConfig(10, 10, 10), "cpu")
    res = make_cg(prob.A, max_iter=150, tolerance=0.0, backend="pallas_fused")(prob.b, prob.x0)
    trace = res.trace.numpy()
    assert int(res.niters) == GOLDEN_10_NITERS
    np.testing.assert_allclose(trace[0], GOLDEN_10_TRACE[0], rtol=1e-5)
    np.testing.assert_allclose(trace[15], GOLDEN_10_TRACE[15], rtol=1e-4)
    for k, ref in GOLDEN_10_TRACE.items():
        if k > 15:
            assert abs(np.log10(trace[k]) - np.log10(ref)) < 0.05 * abs(np.log10(ref)) + 1.0
