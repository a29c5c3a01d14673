"""bf16 storage on K1-K4 and on the backends that run them, against the JAX
package's Pallas kernels and its bf16 ``pallas`` solves, on the CPU.

The port's wrappers run their kernels' plain versions here (f32 compute,
bf16 storage, f32 partials: the rule of the CUDA instances); the Pallas
kernels run in interpret mode. JAX computes K1/K2 in f32 in-kernel
(``stencil_v2.py:137-142``) but K3/K4 and the scalar recurrence in bf16
(``fused_cg.py``), so the two round at other places. Inputs are made with
numpy from a seed and rounded to bf16 on both sides (the same bits); beta
and alpha are exact in bf16.

Tolerances: vectors within 2^-6 of max|y| (two bf16 ulps at the top of the
range), dots within 5% + 1 (``tests/test_pallas.py:443``); whole solves as
``tests/test_pallas.py:448-470``: the trace within rtol 0.15 where JAX's is
above 0.05 of its trace[0], and the bf16 storage floor of x (max|x - 1| <
0.08 on one device, < 0.1 on the mesh).

The CUDA instances against their plain versions on the card:
``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import hpccg_tpu  # noqa: E402
from hpccg_tpu.config import Stencil as JStencil  # noqa: E402
from hpccg_tpu.operators import StencilOperator as JStencilOperator  # noqa: E402
from hpccg_tpu.ops.pallas.fused_cg import fused_update_p_apply, fused_update_x_r  # noqa: E402
from hpccg_tpu.ops.pallas.stencil_kernel import pad_plane, plane_masks, unpad_plane  # noqa: E402
from hpccg_tpu.ops.pallas.stencil_v2 import (  # noqa: E402
    pad_plane3,
    padded_dims,
    spmv_padded_v2,
    spmv_padded_v2_pap,
    unpad_plane3,
)
from hpccg_tpu.parallel import make_mesh as jmake_mesh  # noqa: E402
from hpccg_tpu.parallel.cg import generate_problem_sharded as jgenerate_sharded  # noqa: E402
from hpccg_tpu.parallel.cg import make_distributed_cg as jmake_distributed_cg  # noqa: E402
from hpccg_tpu.solver import make_cg as jmake_cg  # noqa: E402
from hpccg_tpu_torch import ProblemConfig  # noqa: E402
from hpccg_tpu_torch.config import Stencil  # noqa: E402
from hpccg_tpu_torch.convert import problem_from_numpy  # noqa: E402
from hpccg_tpu_torch.operators import StencilOperator  # noqa: E402
from hpccg_tpu_torch.ops.cuda import fused_cg as fc  # noqa: E402
from hpccg_tpu_torch.ops.cuda import stencil as st  # noqa: E402
from hpccg_tpu_torch.parallel import generate_problem_sharded, make_distributed_cg, make_mesh  # noqa: E402
from hpccg_tpu_torch.parallel.cg import resolve_distributed_backend  # noqa: E402
from hpccg_tpu_torch.solver import make_cg  # noqa: E402

DIMS = (20, 12, 9)
VEC_TOL = 2.0**-6  # of max|y|
BETA, ALPHA = 0.375, 0.1875  # exact in bf16
BF16 = torch.bfloat16


def _ops(stencil):
    nx, ny, nz = DIMS
    return (StencilOperator(nx, ny, nz, Stencil(stencil), BF16),
            JStencilOperator(nx, ny, nz, JStencil(stencil), jnp.bfloat16))


def _rand(rng, *shape):
    """float32 normals, rounded to bf16 on both sides alike."""
    return rng.standard_normal(shape).astype(np.float32)


def _t(x, shape=None):
    t = torch.from_numpy(x).to(BF16)
    return t if shape is None else t.view(*shape)


def _j(x):
    return jnp.asarray(x, jnp.bfloat16)


def _vec(got, want):
    got = got.float().numpy().reshape(-1)
    want = np.asarray(want).astype(np.float32).reshape(-1)
    scale = np.abs(want).max() or 1.0
    assert np.abs(got - want).max() <= VEC_TOL * scale


def _dot(got, want):
    assert got.dtype == torch.float32  # the port's partials are f32 (config.scalar_dtype)
    got, want = float(got), float(want)
    assert abs(got - want) < 0.05 * abs(want) + 1.0


def _halo_v2(jop, planes):
    _, nyp, nxp = padded_dims(jop, jnp.bfloat16)
    h = np.zeros((planes.shape[0], nyp, nxp), np.float32)
    h[:, : jop.ny, : jop.nx] = planes
    return _j(h)


def _halo_v1(jop, planes):
    m = plane_masks(jop, jnp.bfloat16).shape[1]
    h = np.zeros((planes.shape[0], m), np.float32)
    h[:, : jop.ny * jop.nx] = planes.reshape(planes.shape[0], -1)
    return _j(h)


@pytest.mark.parametrize("with_halo", [False, True])
@pytest.mark.parametrize("stencil", [27, 7])
def test_k1_k2_bf16_match_stencil_v2(stencil, with_halo):
    op, jop = _ops(stencil)
    grid = (op.nz, op.ny, op.nx)
    rng = np.random.default_rng(10)
    x = _rand(rng, op.local_nrow)
    halo = _rand(rng, 2, op.ny, op.nx) if with_halo else None
    jhalo = None if halo is None else _halo_v2(jop, halo)
    thalo = None if halo is None else _t(halo)
    u = pad_plane3(jop, _j(x))
    y = st.spmv_stencil(op, _t(x, grid), thalo)
    assert y.dtype == BF16
    _vec(y, unpad_plane3(jop, spmv_padded_v2(jop, u, jhalo)))
    y_j, pap_j = spmv_padded_v2_pap(jop, u, jhalo)
    y2, parts = st.spmv_stencil_pap(op, _t(x, grid), thalo)
    _vec(y2, unpad_plane3(jop, y_j))
    _dot(parts.sum(), pap_j)


@pytest.mark.parametrize("with_halo", [False, True])
@pytest.mark.parametrize("stencil", [27, 7])
def test_k3_bf16_matches_fused_update_p_apply(stencil, with_halo):
    op, jop = _ops(stencil)
    grid = (op.nz, op.ny, op.nx)
    rng = np.random.default_rng(11)
    r, p = _rand(rng, op.local_nrow), _rand(rng, op.local_nrow)
    halo = _rand(rng, 4, op.ny, op.nx) if with_halo else None
    masks = jnp.asarray(plane_masks(jop, jnp.bfloat16))
    pp_j, ap_j, pap_j = fused_update_p_apply(jop, pad_plane(jop, _j(r)), pad_plane(jop, _j(p)),
                                             jnp.asarray(BETA, jnp.bfloat16), masks,
                                             None if halo is None else _halo_v1(jop, halo))
    pp, ap, parts = st.update_p_apply(op, _t(r, grid), _t(p, grid), torch.tensor([BETA]),
                                      None if halo is None else _t(halo))
    assert pp.dtype == ap.dtype == BF16
    _vec(pp, unpad_plane(jop, pp_j))
    _vec(ap, unpad_plane(jop, ap_j))
    _dot(parts.sum(), pap_j)


@pytest.mark.parametrize("stencil", [27, 7])
def test_k4_bf16_matches_fused_update_x_r(stencil):
    op, jop = _ops(stencil)
    rng = np.random.default_rng(12)
    x, r, p, ap = (_rand(rng, op.local_nrow) for _ in range(4))
    x_j, r_j, rr_j = fused_update_x_r(*(pad_plane(jop, _j(v)) for v in (x, r, p, ap)),
                                      jnp.asarray(ALPHA, jnp.bfloat16))
    xt, rt = _t(x), _t(r)
    out_x, out_r, parts = fc.update_x_r(xt, rt, _t(p), _t(ap), torch.tensor([ALPHA]))
    assert out_x is xt and out_r is rt and xt.dtype == BF16  # in place
    _vec(xt, unpad_plane(jop, x_j))
    _vec(rt, unpad_plane(jop, r_j))
    _dot(parts.sum(), rr_j)


def test_bf16_plain_rounds_where_the_kernels_store():
    """The plain versions compute in f32 and round once where they store:
    K3's p' is round(r + beta p), its Ap' round(A p') from the stored p',
    its partial the f32 sum over the stored values; K4's r' is
    round(r - alpha Ap) and its partial the f32 r'.r'."""
    op, _ = _ops(27)
    grid = (op.nz, op.ny, op.nx)
    rng = np.random.default_rng(13)
    r, p = _t(_rand(rng, op.local_nrow), grid), _t(_rand(rng, op.local_nrow), grid)
    beta = torch.tensor([BETA])
    pp, ap, parts = st.update_p_apply(op, r, p, beta)
    want_p = (r.float() + BETA * p.float()).to(BF16)
    assert torch.equal(pp, want_p)
    assert torch.equal(ap, op.matvec(want_p.float().reshape(-1)).to(BF16).view(grid))
    torch.testing.assert_close(parts.sum(), torch.dot(pp.float().reshape(-1), ap.float().reshape(-1)))
    x, rr, q = r.clone(), r.clone(), p.clone()
    _, _, parts = fc.update_x_r(x, rr, q, q, torch.tensor([ALPHA]))
    assert torch.equal(rr, (r.float() - ALPHA * q.float()).to(BF16))
    torch.testing.assert_close(parts.sum(), torch.dot(rr.float().reshape(-1), rr.float().reshape(-1)))


@pytest.fixture(scope="module")
def slice_problem():
    jprob = hpccg_tpu.generate_problem(hpccg_tpu.ProblemConfig(12, 10, 9, dtype=jnp.bfloat16))
    prob = problem_from_numpy(12, 10, 9, 27, np.asarray(jprob.b), np.asarray(jprob.x0), np.asarray(jprob.xexact),
                              device="cpu")
    jres = jmake_cg(jprob.A, max_iter=25, backend="pallas")(jprob.b, jprob.x0)
    return prob, np.asarray(jres.trace, np.float32)


def _held(trace, jtrace):
    good = np.isfinite(jtrace) & (jtrace > 0.05 * jtrace[0])
    np.testing.assert_allclose(trace[good], jtrace[good], rtol=0.15)


@pytest.mark.parametrize("backend", ["pallas", "pallas_fused", "pallas_v1"])
def test_bf16_slice_matches_jax_pallas(slice_problem, backend):
    """make_cg in bf16 on the kernel backends (x bf16, scalars and trace
    f32) against JAX's bf16 pallas solve at 12x10x9, 25 iterations."""
    prob, jtrace = slice_problem
    assert prob.b.dtype == BF16
    res = make_cg(prob.A, max_iter=25, backend=backend)(prob.b, prob.x0)
    assert res.x.dtype == BF16 and res.trace.dtype == res.normr.dtype == torch.float32
    assert int(res.niters) == 24
    assert float((res.x.float() - 1).abs().max()) < 0.08
    _held(res.trace.numpy(), jtrace)


@pytest.fixture(scope="module")
def mesh_reference():
    cfg = hpccg_tpu.ProblemConfig(6, 5, 4, dtype=jnp.bfloat16)
    jmesh = jmake_mesh(4)
    jprob = jgenerate_sharded(cfg, jmesh)
    jres = jmake_distributed_cg(cfg, jmesh, max_iter=20, backend="pallas")(jprob.b, jprob.x0)
    return np.asarray(jres.trace, np.float32)


@pytest.mark.parametrize("backend", ["auto", "pallas", "pallas_fused", "pallas_v1"])
def test_bf16_distributed_matches_jax_pallas(mesh_reference, backend):
    """Four ranks of 6x5x4 bf16 shards, bf16 halo planes, against JAX's
    distributed pallas (tests/test_pallas.py:461-470); ``auto`` is
    ``stencil`` on the CPU."""
    cfg = ProblemConfig(6, 5, 4, dtype=BF16)
    mesh = make_mesh(4, devices=["cpu"] * 4)
    prob = generate_problem_sharded(cfg, mesh)
    res = make_distributed_cg(cfg, mesh, max_iter=20, backend=backend)(prob.b, prob.x0)
    assert all(v.dtype == BF16 for v in res.x)
    assert int(res.niters) == 19
    assert float(max((v.float() - 1).abs().max() for v in res.x)) < 0.1
    _held(res.trace.float().numpy(), mesh_reference)


def test_bf16_distributed_auto_is_pallas_on_cuda():
    """JAX's distributed auto picks pallas for 2-byte state
    (hpccg_tpu/parallel/cg.py:156-158); so does the port on CUDA (no card
    needed to resolve it)."""
    cfg = ProblemConfig(6, 5, 4, dtype=BF16)
    assert resolve_distributed_backend(cfg, "auto", "cuda") == "pallas"
    assert resolve_distributed_backend(cfg, "auto", "cpu") == "stencil"
    with pytest.raises(ValueError, match="bfloat16"):
        make_distributed_cg(cfg, make_mesh(2, devices=["cpu"] * 2), max_iter=5, backend="pallas_dd")
