"""The port's kernels K1-K4 and K7 against the JAX package's Pallas kernels.

On the CPU every wrapper runs its kernel's plain torch version; the Pallas
kernels run in interpret mode, as the JAX package's own tests run them. The
JAX side pads and unpads into its TPU layouts (v2 ``pad_plane3`` for K1/K2,
v1 ``pad_plane`` for K3/K4/K8); the port works on the flat layout as a
(nz, ny, nx) grid.

Tolerances (max |port - jax| over max |jax| for vectors, relative for dots):
f64 1e-13 / 1e-12, f32 1e-5 / 1e-4. The kernels sum in another order than
Pallas does (its grid steps, its lane padding), so the last bits differ.

The CUDA kernels against their plain versions on the card:
``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from hpccg_tpu.config import Stencil as JStencil  # noqa: E402
from hpccg_tpu.operators import StencilOperator as JStencilOperator  # noqa: E402
from hpccg_tpu.ops.pallas.fused_cg import fused_update_p_apply, fused_update_x_r  # noqa: E402
from hpccg_tpu.ops.pallas.stencil_kernel import (  # noqa: E402
    pad_plane,
    plane_masks,
    spmv_padded,
    unpad_plane,
)
from hpccg_tpu.ops.pallas.stencil_v2 import (  # noqa: E402
    pad_plane3,
    padded_dims,
    spmv_padded_v2,
    spmv_padded_v2_dd_pap,
    spmv_padded_v2_pap,
    unpad_plane3,
)
from hpccg_tpu_torch.config import Stencil  # noqa: E402
from hpccg_tpu_torch.operators import StencilOperator  # noqa: E402
from hpccg_tpu_torch.ops.cuda import fused_cg as fc  # noqa: E402
from hpccg_tpu_torch.ops.cuda import stencil as st  # noqa: E402
from hpccg_tpu_torch.solver import make_cg  # noqa: E402

VEC_RTOL = {"float64": 1e-13, "float32": 1e-5}
DOT_RTOL = {"float64": 1e-12, "float32": 1e-4}

# (nx, ny, nz), stencil, JAX v2 slab depth: non-cubic grids, a grid one cell
# thick, and nz not a multiple of tz (the z-padding path)
CASES = [
    ((9, 5, 7), 27, 2),
    ((9, 5, 7), 7, 2),
    ((6, 1, 4), 27, None),
    ((12, 10, 9), 27, 4),
    ((5, 3, 1), 7, None),
]
IDS = [f"{d[0]}x{d[1]}x{d[2]}-{s}pt" for d, s, _ in CASES]


def _ops(dims, stencil, dtype):
    nx, ny, nz = dims
    return (
        StencilOperator(nx, ny, nz, Stencil(stencil), getattr(torch, dtype)),
        JStencilOperator(nx, ny, nz, JStencil(stencil), dtype),
    )


def _rand(rng, dtype, *shape):
    return rng.standard_normal(shape).astype(dtype)


def _vec(got, want, dtype):
    got, want = np.asarray(got).reshape(-1), np.asarray(want).reshape(-1)
    assert got.dtype == want.dtype
    scale = np.abs(want).max() or 1.0
    assert np.abs(got - want).max() <= VEC_RTOL[dtype] * scale


def _dot(got, want, dtype):
    np.testing.assert_allclose(float(got), float(want), rtol=DOT_RTOL[dtype])


def _halo_v2(jop, planes, dtype):
    """(k, ny, nx) planes -> the v2 halo layout (k, ny_pad, nx_pad)."""
    _, nyp, nxp = padded_dims(jop, dtype)
    h = np.zeros((planes.shape[0], nyp, nxp), dtype)
    h[:, : jop.ny, : jop.nx] = planes
    return jnp.asarray(h)


def _halo_v1(jop, planes, dtype):
    """(k, ny, nx) planes -> the v1 halo layout (k, M)."""
    m = plane_masks(jop, dtype).shape[1]
    h = np.zeros((planes.shape[0], m), dtype)
    h[:, : jop.ny * jop.nx] = planes.reshape(planes.shape[0], -1)
    return jnp.asarray(h)


def _grid(op, x):
    return torch.from_numpy(x).view(op.nz, op.ny, op.nx)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_k1_matches_stencil_v2(case, dtype):
    dims, stencil, tz = case
    op, jop = _ops(dims, stencil, dtype)
    rng = np.random.default_rng(0)
    x = _rand(rng, dtype, op.local_nrow)
    halo = _rand(rng, dtype, 2, op.ny, op.nx)
    u = pad_plane3(jop, jnp.asarray(x), tz)
    # without external planes (the domain boundary), then with them
    want = unpad_plane3(jop, spmv_padded_v2(jop, u, None, False, tz))
    _vec(st.spmv_stencil(op, _grid(op, x)).numpy(), want, dtype)
    want = unpad_plane3(jop, spmv_padded_v2(jop, u, _halo_v2(jop, halo, dtype), False, tz))
    _vec(st.spmv_stencil(op, _grid(op, x), torch.from_numpy(halo)).numpy(), want, dtype)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_k2_matches_stencil_v2_pap(case, dtype):
    dims, stencil, tz = case
    op, jop = _ops(dims, stencil, dtype)
    rng = np.random.default_rng(1)
    x = _rand(rng, dtype, op.local_nrow)
    halo = _rand(rng, dtype, 2, op.ny, op.nx)
    y_j, pap_j = spmv_padded_v2_pap(
        jop, pad_plane3(jop, jnp.asarray(x), tz), _halo_v2(jop, halo, dtype), False, tz
    )
    y, parts = st.spmv_stencil_pap(op, _grid(op, x), torch.from_numpy(halo))
    _vec(y.numpy(), unpad_plane3(jop, y_j), dtype)
    _dot(parts.sum(), pap_j, dtype)


@pytest.mark.parametrize("with_halo", [False, True])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_k3_matches_fused_update_p_apply(case, dtype, with_halo):
    dims, stencil, _ = case
    op, jop = _ops(dims, stencil, dtype)
    rng = np.random.default_rng(2)
    r, p = _rand(rng, dtype, op.local_nrow), _rand(rng, dtype, op.local_nrow)
    halo = _rand(rng, dtype, 4, op.ny, op.nx) if with_halo else None
    beta = 0.37
    masks = jnp.asarray(plane_masks(jop, dtype))
    pp_j, ap_j, pap_j = fused_update_p_apply(
        jop, pad_plane(jop, jnp.asarray(r)), pad_plane(jop, jnp.asarray(p)),
        jnp.asarray(beta, dtype), masks, None if halo is None else _halo_v1(jop, halo, dtype),
    )
    pp, ap, parts = st.update_p_apply(
        op, _grid(op, r), _grid(op, p), torch.tensor([beta], dtype=getattr(torch, dtype)),
        None if halo is None else torch.from_numpy(halo),
    )
    _vec(pp.numpy(), unpad_plane(jop, pp_j), dtype)
    _vec(ap.numpy(), unpad_plane(jop, ap_j), dtype)
    _dot(parts.sum(), pap_j, dtype)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("case", CASES[:3], ids=IDS[:3])
def test_k4_matches_fused_update_x_r(case, dtype):
    dims, stencil, _ = case
    op, jop = _ops(dims, stencil, dtype)
    rng = np.random.default_rng(3)
    x, r, p, ap = (_rand(rng, dtype, op.local_nrow) for _ in range(4))
    alpha = 0.21
    x_j, r_j, rr_j = fused_update_x_r(
        *(pad_plane(jop, jnp.asarray(v)) for v in (x, r, p, ap)), jnp.asarray(alpha, dtype)
    )
    xt, rt = torch.from_numpy(x.copy()), torch.from_numpy(r.copy())
    out_x, out_r, parts = fc.update_x_r(
        xt, rt, torch.from_numpy(p), torch.from_numpy(ap),
        torch.tensor([alpha], dtype=getattr(torch, dtype)),
    )
    assert out_x is xt and out_r is rt  # updated in place, as fused_cg.py:231 aliases
    _vec(xt.numpy(), unpad_plane(jop, x_j), dtype)
    _vec(rt.numpy(), unpad_plane(jop, r_j), dtype)
    _dot(parts.sum(), rr_j, dtype)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_k1_matches_k8_spmv_padded(case, dtype):
    """The v1-layout kernel (K8), which JAX's pallas_fused uses for its
    initial Ap, computes K1's product."""
    dims, stencil, _ = case
    op, jop = _ops(dims, stencil, dtype)
    rng = np.random.default_rng(4)
    x = _rand(rng, dtype, op.local_nrow)
    halo = _rand(rng, dtype, 2, op.ny, op.nx)
    masks = jnp.asarray(plane_masks(jop, dtype))
    u = pad_plane(jop, jnp.asarray(x))
    _vec(st.spmv_stencil(op, _grid(op, x)).numpy(), unpad_plane(jop, spmv_padded(jop, u, masks)), dtype)
    want = unpad_plane(jop, spmv_padded(jop, u, masks, _halo_v1(jop, halo, dtype)))
    _vec(st.spmv_stencil(op, _grid(op, x), torch.from_numpy(halo)).numpy(), want, dtype)


@pytest.mark.parametrize("case", [((13, 10, 7), 27), ((13, 10, 7), 7)], ids=["13x10x7-27pt", "13x10x7-7pt"])
def test_k7_matches_stencil_v2_dd_pap(case):
    """K7 (K2's float64 instance, backend pallas_dd) against the TPU's
    double-float kernel: y rtol 1e-13 (max |d| over max |y|), p.Ap rtol
    1e-12. The input carries full f64 significands (an f32-representable x
    would hide the dd kernel's lo channel)."""
    dims, stencil = case
    op, jop = _ops(dims, stencil, "float64")
    rng = np.random.default_rng(5)
    n = op.local_nrow
    x = rng.standard_normal(n) * (1 + 1e-9 * rng.standard_normal(n))
    y_j, pap_j = spmv_padded_v2_dd_pap(jop, pad_plane3(jop, jnp.asarray(x)))
    y, parts = st.spmv_stencil_pap_dd(op, _grid(op, x))
    _vec(y.numpy(), unpad_plane3(jop, y_j), "float64")
    _dot(parts.sum(), pap_j, "float64")


def test_k7_refuses_float32():
    op = StencilOperator(6, 5, 4, dtype=torch.float32)
    with pytest.raises(ValueError, match="pallas_dd"):
        st.spmv_stencil_pap_dd(op, torch.zeros(4, 5, 6))
    with pytest.raises(ValueError, match="pallas_dd"):
        make_cg(op, backend="pallas_dd")  # the same check, at the backend


def test_inactive_launches_write_nothing():
    op = StencilOperator(5, 4, 3)
    g = torch.randn(3, 4, 5, dtype=torch.float64, generator=torch.Generator().manual_seed(0))
    off = torch.zeros((1,), dtype=torch.int32)
    out, out2, parts = torch.full_like(g, 7.0), torch.full_like(g, 8.0), torch.full((1,), 9.0, dtype=g.dtype)
    st.spmv_stencil(op, g, out=out, active=off)
    st.spmv_stencil_pap(op, g, out=out, partials=parts, active=off)
    st.spmv_stencil_pap_dd(op, g, out=out, partials=parts, active=off)
    st.update_p_apply(op, g, g.clone(), torch.ones(1, dtype=g.dtype), out_p=out, out_ap=out2,
                      partials=parts, active=off)
    x, r = g.clone(), g.clone()
    fc.update_x_r(x, r, g, g, torch.ones(1, dtype=g.dtype), partials=parts, active=off)
    assert (out == 7.0).all() and (out2 == 8.0).all() and (parts == 9.0).all()
    assert torch.equal(x, g) and torch.equal(r, g)


def test_wrappers_reject_what_the_kernels_do_not_take():
    op = StencilOperator(5, 4, 3)
    g = torch.zeros(3, 4, 5, dtype=torch.float64)
    with pytest.raises(ValueError):
        st.spmv_stencil(op, torch.zeros(3, 4, 6, dtype=torch.float64))
    with pytest.raises(TypeError):
        st.spmv_stencil(op, g.to(torch.int64))
    with pytest.raises(TypeError):
        st.spmv_stencil(op, g, out=torch.zeros(3, 4, 5, dtype=torch.float32))
    with pytest.raises(ValueError):
        st.spmv_stencil(op, torch.zeros(3, 5, 4, dtype=torch.float64).transpose(1, 2))
    with pytest.raises(ValueError):
        st.spmv_stencil(op, g, out=g)  # blocks read the planes others write
    with pytest.raises(ValueError):
        st.update_p_apply(op, g, g.clone(), torch.zeros(2, dtype=g.dtype))
    with pytest.raises(ValueError):
        fc.update_x_r(g, g.clone(), g.clone(), g.clone(), torch.zeros(1, dtype=g.dtype),
                      partials=torch.zeros(2, dtype=g.dtype))
    with pytest.raises(ValueError):
        fc.cg_finalize(torch.zeros(1, dtype=g.dtype), fc.CGScalars.new(g.dtype, 5, 0.0, "cpu"), 7)


def test_finalize_recurrence_and_exit():
    """The plain finalize follows the reference loop: trace[0] = trace[1] =
    sqrt(r0.r0), beta = 0 at k = 1, alpha = rtrans / p.Ap, exit when k
    reaches max_iter; steps after the exit change nothing."""
    s = fc.CGScalars.new(torch.float64, 3, 0.0, "cpu")
    one = lambda v: torch.tensor([v], dtype=torch.float64)  # noqa: E731
    fc.cg_finalize(one(16.0), s, fc.STEP_INIT)
    assert s.trace[:2].tolist() == [4.0, 4.0] and int(s.ic[fc.IC_K]) == 1
    assert int(s.active) == 1 and float(s.beta) == 0.0
    fc.cg_finalize(one(8.0), s, fc.STEP_PAP)
    assert float(s.alpha) == 2.0
    fc.cg_finalize(one(4.0), s, fc.STEP_RR)  # end of body 1 -> top of body 2
    assert int(s.ic[fc.IC_K]) == 2 and float(s.beta) == 0.25 and float(s.trace[2]) == 2.0
    fc.cg_finalize(one(2.0), s, fc.STEP_PAP)
    fc.cg_finalize(one(1.0), s, fc.STEP_RR)  # k = 3 = max_iter: exit
    assert int(s.active) == 0 and int(s.ic[fc.IC_K]) == 3
    assert float(s.alpha) == 0.0 and float(s.beta) == 0.0
    assert float(s.sc[fc.SC_NORMR]) == 2.0  # the normr of the last body's top
    before = (s.sc.clone(), s.ic.clone())
    fc.cg_finalize(one(5.0), s, fc.STEP_PAP)
    fc.cg_finalize(one(5.0), s, fc.STEP_RR)
    assert torch.equal(before[0], s.sc) and torch.equal(before[1], s.ic)
