"""The CUDA kernels against their plain torch versions, on the card.

Every test here is marked ``cuda`` and skips without an NVIDIA GPU. The file
imports torch only, so that the machine with the card, which has no jax,
runs it without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py

Tolerances as in test_torch_kernels.py (max |kernel - plain| over max |plain|
for vectors, relative for dots): f64 1e-13 / 1e-12, f32 1e-5 / 1e-4.
"""

import pytest

torch = pytest.importorskip("torch")

from hpccg_tpu_torch import ProblemConfig, generate_problem, make_cg  # noqa: E402
from hpccg_tpu_torch.config import Stencil  # noqa: E402
from hpccg_tpu_torch.operators import StencilOperator  # noqa: E402
from hpccg_tpu_torch.ops.cuda import fused_cg as fc  # noqa: E402
from hpccg_tpu_torch.ops.cuda import stencil as st  # noqa: E402

pytestmark = pytest.mark.cuda

VEC_RTOL = {torch.float64: 1e-13, torch.float32: 1e-5}
DOT_RTOL = {torch.float64: 1e-12, torch.float32: 1e-4}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda is not available)")
    return torch.device("cuda")


def _vec(got, want):
    scale = float(want.abs().max()) or 1.0
    assert float((got - want).abs().max()) <= VEC_RTOL[want.dtype] * scale


def _dot(got, want):
    torch.testing.assert_close(got, want, rtol=DOT_RTOL[want.dtype], atol=0)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("stencil", [27, 7])
@pytest.mark.parametrize("dims", [(33, 17, 9), (6, 1, 4), (5, 3, 1)])
def test_kernels_match_plain(cuda_device, dims, stencil, dtype):
    nx, ny, nz = dims
    op = StencilOperator(nx, ny, nz, Stencil(stencil), dtype)
    gen = torch.Generator(device=cuda_device).manual_seed(0)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=cuda_device, dtype=dtype)

    u, p, ap = rnd(nz, ny, nx), rnd(nz, ny, nx), rnd(nz, ny, nx)
    h2, h4 = rnd(2, ny, nx), rnd(4, ny, nx)
    beta = torch.tensor([0.37], device=cuda_device, dtype=dtype)
    for halo in (None, h2):
        _vec(st.spmv_stencil(op, u, halo), st.spmv_stencil_plain(op, u, halo))
    y, parts = st.spmv_stencil_pap(op, u, h2)
    y0, parts0 = st.spmv_stencil_pap_plain(op, u, h2)
    _vec(y, y0)
    _dot(parts.sum(), parts0.sum())
    for halo in (None, h4):
        pp, app, parts = st.update_p_apply(op, u, p, beta, halo)
        pp0, app0, parts0 = st.update_p_apply_plain(op, u, p, beta, halo)
        _vec(pp, pp0)
        _vec(app, app0)
        _dot(parts.sum(), parts0.sum())
    x1, r1, x2, r2 = u.clone(), p.clone(), u.clone(), p.clone()
    _, _, parts = fc.update_x_r(x1, r1, ap, u, beta)
    _, _, parts0 = fc.update_x_r_plain(x2, r2, ap, u, beta)
    _vec(x1, x2)
    _vec(r1, r2)
    _dot(parts.sum(), parts0.sum())
    torch.cuda.synchronize()


def test_inactive_kernels_write_nothing(cuda_device):
    op = StencilOperator(9, 5, 7)
    u = torch.randn(7, 5, 9, device=cuda_device, dtype=torch.float64)
    off = torch.zeros((1,), dtype=torch.int32, device=cuda_device)
    out, out2 = torch.full_like(u, 7.0), torch.full_like(u, 8.0)
    st.spmv_stencil(op, u, out=out, active=off)
    st.update_p_apply(op, u, u.clone(), torch.ones(1, dtype=u.dtype, device=cuda_device),
                      out_p=out, out_ap=out2, active=off)
    x = u.clone()
    fc.update_x_r(x, u.clone(), u, u, torch.ones(1, dtype=u.dtype, device=cuda_device), active=off)
    assert bool((out == 7.0).all()) and bool((out2 == 8.0).all()) and torch.equal(x, u)


def test_finalize_matches_plain(cuda_device):
    states = [fc.CGScalars.new(torch.float64, 6, 1e-30, cuda_device) for _ in range(2)]
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    for step in [fc.STEP_INIT] + [fc.STEP_PAP, fc.STEP_RR] * 6:
        parts = torch.rand((300,), generator=gen, device=cuda_device, dtype=torch.float64) + 0.5
        fc.cg_finalize(parts, states[0], step)
        fc.cg_finalize_plain(parts, states[1], step)
    a, b = states
    assert torch.equal(a.ic, b.ic) and int(a.ic[fc.IC_K]) == 6 and int(a.ic[fc.IC_ACTIVE]) == 0
    torch.testing.assert_close(a.sc, b.sc, rtol=1e-12, atol=0)
    torch.testing.assert_close(a.trace, b.trace, rtol=1e-12, atol=0, equal_nan=True)


@pytest.mark.parametrize("backend", ["pallas", "pallas_fused"])
def test_solver_matches_stencil_backend(cuda_device, backend):
    """f64 trajectories of the kernel backends against plain torch, with the
    host reading `active` every 16 iterations and a tolerance exit."""
    prob = generate_problem(ProblemConfig(12, 10, 9), cuda_device)
    ref = make_cg(prob.A, max_iter=500, tolerance=1e-10, backend="stencil")(prob.b, prob.x0)
    res = make_cg(prob.A, max_iter=500, tolerance=1e-10, backend=backend)(prob.b, prob.x0)
    assert int(res.niters) == int(ref.niters) < 499
    head = ref.trace > 1e-11 * ref.trace[0]
    torch.testing.assert_close(res.trace[head], ref.trace[head], rtol=1e-10, atol=0)
    torch.testing.assert_close(res.x, ref.x, rtol=1e-12, atol=0)
