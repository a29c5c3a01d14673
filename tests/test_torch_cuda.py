"""The CUDA kernels against their plain torch versions, on the card.

Every test here is marked ``cuda`` and skips without an NVIDIA GPU. The file
imports torch only, so that the machine with the card, which has no jax,
runs it without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py

Tolerances as in test_torch_kernels.py (max |kernel - plain| over max |plain|
for vectors, relative for dots): f64 1e-13 / 1e-12, f32 1e-5 / 1e-4. The
whole-solve kernels K5/K6 against their plain versions, at 33x17x9 and at
200x170x150 (more work items than blocks, so blocks take several in turns):
niters equal, the trace within 1e-10 / 1e-4 / 1.5e-2 (f64 / f32 / bf16)
while it stays above 1e-11 / 1e-5 / 1e-4 of trace[0] (the solve stops
there, on a tolerance between two of the plain trace's entries), x within
1e-12 / 1e-5 of max|x| (bf16: at most 4 ulps apart, in at most 1e-3 of the
elements), one launch per solve, and two solves bit-identical. The bf16
limits are about twice the largest readings on an H100 (chip_smoke.py).
"""

import dataclasses
import warnings

import pytest

torch = pytest.importorskip("torch")

from hpccg_tpu_torch import ProblemConfig, generate_problem, make_cg  # noqa: E402
from hpccg_tpu_torch.config import Stencil  # noqa: E402
from hpccg_tpu_torch.operators import StencilOperator  # noqa: E402
from hpccg_tpu_torch.ops.cuda import fused_cg as fc  # noqa: E402
from hpccg_tpu_torch.ops.cuda import megakernel as mk  # noqa: E402
from hpccg_tpu_torch.ops.cuda import stencil as st  # noqa: E402
from hpccg_tpu_torch.ops.cuda import streamkernel as sk  # noqa: E402

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


def test_k7_matches_plain(cuda_device):
    op = StencilOperator(33, 17, 9, dtype=torch.float64)
    u = torch.randn(9, 17, 33, device=cuda_device, dtype=torch.float64)
    before = st.spmv_stencil_pap_dd.launches
    y, parts = st.spmv_stencil_pap_dd(op, u)
    y0, parts0 = st.spmv_stencil_pap_plain(op, u)
    assert st.spmv_stencil_pap_dd.launches == before + 1
    _vec(y, y0)
    _dot(parts.sum(), parts0.sum())
    with pytest.raises(ValueError, match="pallas_dd"):
        st.spmv_stencil_pap_dd(op, u.float())


WS_TRACE = {torch.float64: (1e-10, 1e-11), torch.float32: (1e-4, 1e-5), torch.bfloat16: (1.5e-2, 1e-4)}
WS_X_RTOL = {torch.float64: 1e-12, torch.float32: 1e-5}


def _x_close(got, want, rtol=None):
    if got.dtype == torch.bfloat16:
        def ordered(t):  # bf16 bits as integers in the order of the values
            v = t.view(torch.int16).to(torch.int32)
            return torch.where(v < 0, -32768 - v, v)

        assert int((ordered(got) - ordered(want)).abs().max()) <= 4
        assert float((got != want).double().mean()) <= 1e-3
    else:
        rtol = WS_X_RTOL[got.dtype] if rtol is None else rtol
        assert float((got - want).abs().max()) <= rtol * float(want.abs().max())


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32, torch.bfloat16])
@pytest.mark.parametrize("stencil", [27, 7])
@pytest.mark.parametrize("which", ["mega", "stream"])
@pytest.mark.parametrize("dims", [(33, 17, 9), (200, 170, 150)], ids=["33x17x9", "200x170x150"])
def test_whole_solve_matches_plain(cuda_device, dims, which, stencil, dtype):
    from hpccg_tpu_torch.ops.cuda import wholesolve

    kern, plain = ((mk.cg_solve_mega, mk.cg_solve_mega_plain) if which == "mega"
                   else (sk.cg_solve_stream, sk.cg_solve_stream_plain))
    prob = generate_problem(ProblemConfig(*dims, stencil=stencil, dtype=dtype), cuda_device)
    if dims != (33, 17, 9):
        assert wholesolve.work_items(prob.A) > wholesolve.num_blocks(prob.A, dtype, which == "stream")
    rtol, floor = WS_TRACE[dtype]
    args = (prob.A, prob.b, prob.x0)
    tr = plain(*args, max_iter=30).trace
    below = torch.nonzero(tr < floor * tr[0])
    tol = 0.0 if below.numel() == 0 else float(torch.sqrt(tr[int(below[0]) - 1] * tr[int(below[0])]))
    want = plain(*args, max_iter=30, tolerance=tol)
    before = kern.launches
    got, again = (kern(*args, max_iter=30, tolerance=tol) for _ in range(2))
    torch.cuda.synchronize()
    assert kern.launches == before + 2
    n = int(want.niters) + 1
    assert int(got.niters) == n - 1
    assert got.x.dtype == dtype and got.trace.dtype == want.trace.dtype
    torch.testing.assert_close(got.trace[:n], want.trace[:n], rtol=rtol, atol=0)
    assert bool(torch.isnan(got.trace[n:]).all())
    _x_close(got.x, want.x)
    assert torch.equal(got.x, again.x) and torch.equal(got.trace[:n], again.trace[:n])


@pytest.mark.parametrize("backend", ["megakernel", "streamkernel", "pallas_dd"])
def test_whole_solve_and_dd_backends_match_stencil(cuda_device, backend):
    """f64 trajectories of the new backends against plain torch, with a
    tolerance exit."""
    prob = generate_problem(ProblemConfig(12, 10, 9), cuda_device)
    ref = make_cg(prob.A, max_iter=500, tolerance=1e-10, backend="stencil")(prob.b, prob.x0)
    res = make_cg(prob.A, max_iter=500, tolerance=1e-10, backend=backend)(prob.b, prob.x0)
    assert int(res.niters) == int(ref.niters) < 499
    head = ref.trace > 1e-11 * ref.trace[0]
    torch.testing.assert_close(res.trace[head], ref.trace[head], rtol=1e-10, atol=0)
    torch.testing.assert_close(res.x, ref.x, rtol=1e-12, atol=0)


# ------------------------------------------------- explicit matrices, K9-K12

from hpccg_tpu_torch.models.stencil import generate_ell  # noqa: E402
from hpccg_tpu_torch.operators import DiaMatrix  # noqa: E402
from hpccg_tpu_torch.ops.cuda import dia as cdia  # noqa: E402
from hpccg_tpu_torch.ops.cuda import ell as cell  # noqa: E402
from hpccg_tpu_torch.reorder import permute_ell  # noqa: E402


def _launches(wrapper) -> int:
    return wrapper.launches_f32 + wrapper.launches_f64


def _random_band(n, ndiag, span, dtype, device, seed=0):
    gen = torch.Generator().manual_seed(seed)
    offs = sorted({0, *torch.randint(-span, span + 1, (ndiag,), generator=gen).tolist()})
    data = torch.randn((len(offs), n), generator=gen, dtype=dtype)
    for d, off in enumerate(offs):  # zeros outside each diagonal
        data[d, : max(0, -off)] = 0
        data[d, min(n, n - off):] = 0
    return DiaMatrix(data=data.to(device), offsets=tuple(offs), total_nrow=n)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("case", ["stencil", "band", "tiny"])
def test_dia_kernel_matches_plain(cuda_device, case, dtype):
    """K9/K10 against the plain version: the same sums in the same order,
    each product and sum rounded on its own, so bit for bit; two launches
    bit-identical; offsets past the 1024-offset shared-memory chunk."""
    if case == "stencil":
        D = generate_ell(ProblemConfig(33, 17, 9, dtype=dtype), cuda_device).A.to_dia()
    elif case == "band":
        D = _random_band(5003, 1500, 3000, dtype, cuda_device)
        assert D.ndiag > 1024
    else:
        D = _random_band(3, 2, 2, dtype, cuda_device)
    P = cdia.prepare_dia(D)
    x = torch.randn(D.local_nrow, dtype=dtype, device=cuda_device)
    before = _launches(cdia.spmv_dia)
    y, again = cdia.spmv_dia(P, x), cdia.spmv_dia(P, x)
    torch.cuda.synchronize()
    assert _launches(cdia.spmv_dia) == before + 2
    assert torch.equal(y, cdia.spmv_dia_plain(P, x)) and torch.equal(y, again)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("case", ["stencil", "permuted", "skewed"])
def test_ell_kernel_matches_plain(cuda_device, case, dtype):
    """K11/K12 against the plain version: within 1e-13 / 1e-5 of max|y|
    (the plain version sums the slots in another order); two launches
    bit-identical."""
    A = generate_ell(ProblemConfig(12, 10, 9, dtype=dtype), "cpu").A
    if case == "permuted":
        A = permute_ell(A, torch.randperm(A.local_nrow, generator=torch.Generator().manual_seed(1)).numpy())
    elif case == "skewed":  # one row of 240 slots
        vals, cols, valid = (torch.zeros((A.local_nrow, 240), dtype=t) for t in (dtype, torch.int32, torch.bool))
        vals[:, :27], cols[:, :27], valid[:, :27] = A.vals, A.cols, A.valid
        vals[5], cols[5], valid[5] = 0.01, torch.arange(240, dtype=torch.int32) * 4, True
        A = dataclasses.replace(A, vals=vals, cols=cols, valid=valid)
    S = cell.prepare_ell(A.to(cuda_device))
    x = torch.randn(A.local_nrow, dtype=dtype, device=cuda_device)
    before = _launches(cell.spmv_ell)
    y, again = cell.spmv_ell(S, x), cell.spmv_ell(S, x)
    torch.cuda.synchronize()
    assert _launches(cell.spmv_ell) == before + 2
    _vec(y, cell.spmv_ell_plain(S, x))
    assert torch.equal(y, again)


def test_sparse_wrappers_refuse_bad_input(cuda_device):
    A = generate_ell(ProblemConfig(6, 5, 4), cuda_device).A
    S, P = cell.prepare_ell(A), cdia.prepare_dia(A.to_dia())
    x = torch.randn(A.local_nrow, dtype=torch.float64, device=cuda_device)
    for fn, layout in ((cell.spmv_ell, S), (cdia.spmv_dia, P)):
        with pytest.raises(ValueError):
            fn(layout, x, out=x)  # out aliases x
        with pytest.raises(TypeError):
            fn(layout, x.float())
        with pytest.raises(ValueError):
            fn(layout, x[:-1])
    bad = dataclasses.replace(A, cols=A.cols.clone().fill_(A.local_nrow))
    with pytest.raises(ValueError, match="outside"):
        cell.prepare_ell(bad)


@pytest.mark.parametrize("fmt", ["ell", "dia"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_explicit_solve_runs_its_kernel(cuda_device, fmt, dtype):
    """make_cg on an explicit matrix launches its kernel once per matvec and
    matches the plain (`stencil`) solve; a bf16 matrix on the card runs the
    kernel's bf16 instance, counted apart."""
    prob = generate_ell(ProblemConfig(16, 12, 10, dtype=dtype), cuda_device)
    A = prob.A if fmt == "ell" else prob.A.to_dia()
    wrapper = cell.spmv_ell if fmt == "ell" else cdia.spmv_dia
    before = _launches(wrapper)
    res = make_cg(A, max_iter=40, tolerance=0.0)(prob.b, prob.x0)
    torch.cuda.synchronize()
    assert _launches(wrapper) - before >= 40
    before = _launches(wrapper)
    ref = make_cg(A, max_iter=40, tolerance=0.0, backend="stencil")(prob.b, prob.x0)
    torch.cuda.synchronize()
    assert _launches(wrapper) == before and int(res.niters) == int(ref.niters) == 39
    rtol, floor = {torch.float64: (1e-10, 1e-11), torch.float32: (1e-4, 1e-5)}[dtype]
    head = ref.trace > floor * ref.trace[0]
    torch.testing.assert_close(res.trace[head], ref.trace[head], rtol=rtol, atol=0)
    bf = generate_ell(ProblemConfig(6, 5, 4, dtype=torch.bfloat16), cuda_device)
    before = (_launches(wrapper), wrapper.launches_bf16)
    res = make_cg(bf.A if fmt == "ell" else bf.A.to_dia(), max_iter=10, tolerance=0.0)(bf.b, bf.x0)
    torch.cuda.synchronize()
    assert (_launches(wrapper), wrapper.launches_bf16 - before[1]) == (before[0], 10)
    assert res.x.dtype == torch.bfloat16 and res.trace.dtype == torch.float32


# ------------------------------------------- collective whole solves, K15/K16

from hpccg_tpu_torch.ops.cuda import collective as col  # noqa: E402
from hpccg_tpu_torch.parallel import generate_problem_sharded, make_distributed_cg, make_mesh  # noqa: E402


def _sharded(cuda_device, ndev, dims, dtype, stencil=27):
    cfg = ProblemConfig(*dims, stencil=stencil, dtype=dtype)
    return cfg, generate_problem_sharded(cfg, make_mesh(ndev, devices=[cuda_device] * ndev))


# pipecg against another run of pipecg: (trace rtol, floor) and x. Its
# w = A r and z = A s recurrences carry each run's rounding forward, and the
# traces part faster than cg's; the limits of chip_smoke.py (readings on an
# H100: f64 4.4e-8 near 3e-10 of trace[0], single device, K1 against the
# plain matvec; f32 2.8e-3 above 1e-4 of trace[0], x 8.7e-5).
PIPE_TRACE = {torch.float64: (1e-6, 1e-9), torch.float32: (1e-2, 1e-4)}
PIPE_X_RTOL = {torch.float64: 1e-12, torch.float32: 2e-3}


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("method", ["cg", "cg1", "pipecg"])
@pytest.mark.parametrize("ndev", [1, 4])
def test_collective_matches_plain(cuda_device, ndev, method, dtype):
    """K15 (cg, cg1) and K16 (pipecg) against their plain versions with
    every rank on one card: niters equal, the trace within WS_TRACE above
    its floor (the solve stops there, as in test_whole_solve_matches_plain),
    x within WS_X_RTOL, one launch per solve, two solves bit-identical.
    pipecg's recurrences drift from each other faster (the JAX package holds
    its pipelined kernel to 1e-8 above 1e-8 of trace[0]): PIPE_TRACE
    (measured on an H100: f64 parts by 6.1e-10 at k = 29 on one rank)."""
    cfg, prob = _sharded(cuda_device, ndev, (33, 17, 9), dtype)
    op = StencilOperator(33, 17, 9, dtype=dtype)
    kern = col.cg_collective_pipelined if method == "pipecg" else col.cg_collective
    kw = {} if method == "pipecg" else {"method": method}
    rtol, floor = (PIPE_TRACE if method == "pipecg" else WS_TRACE)[dtype]
    tr = col.solve_plain(op, prob.b, prob.x0, method=method, max_iter=30).trace
    below = torch.nonzero(tr < floor * tr[0])
    tol = 0.0 if below.numel() == 0 else float(torch.sqrt(tr[int(below[0]) - 1] * tr[int(below[0])]))
    want = col.solve_plain(op, prob.b, prob.x0, method=method, max_iter=30, tolerance=tol)
    before = kern.launches
    got, again = (kern(op, prob.b, prob.x0, max_iter=30, tolerance=tol, **kw) for _ in range(2))
    torch.cuda.synchronize()
    assert kern.launches == before + 2
    n = int(want.niters) + 1
    assert int(got.niters) == n - 1
    torch.testing.assert_close(got.trace[:n], want.trace[:n], rtol=rtol, atol=0)
    assert bool(torch.isnan(got.trace[n:]).all())
    _x_close(torch.cat(got.x), torch.cat(want.x), PIPE_X_RTOL[dtype] if method == "pipecg" else None)
    assert all(torch.equal(a, b) for a, b in zip(got.x, again.x)) and torch.equal(got.trace[:n], again.trace[:n])


def test_collective_backend_matches_stencil_golden(cuda_device):
    """make_distributed_cg(backend="collective") on two ranks of one card:
    the global 10^3 f64 problem, 149 iterations, the golden trace."""
    cfg, prob = _sharded(cuda_device, 2, (10, 10, 5), torch.float64)
    mesh = make_mesh(2, devices=[cuda_device] * 2)
    res = make_distributed_cg(cfg, mesh, max_iter=150, backend="collective", method="cg")(prob.b, prob.x0)
    assert int(res.niters) == 149
    torch.testing.assert_close(res.trace[0], torch.tensor(258.24, dtype=torch.float64, device=cuda_device),
                               rtol=1e-5, atol=0)
    torch.testing.assert_close(res.trace[15], torch.tensor(2.15402e-06, dtype=torch.float64, device=cuda_device),
                               rtol=1e-4, atol=0)


def test_collective_bounded_wait_raises(cuda_device):
    """A 2-rank launch whose waits may last 0 ns gives up at the first wait
    that is not already met: RuntimeError with the error word, no hang."""
    _, prob = _sharded(cuda_device, 2, (33, 17, 9), torch.float32)
    op = StencilOperator(33, 17, 9, dtype=torch.float32)
    with pytest.raises(RuntimeError, match="gave up after 0 ns"):
        col.launch(op, prob.b, prob.x0, method="cg1", max_iter=30, wait_ns=0)
    torch.cuda.synchronize()
    # the card is still usable
    res = col.cg_collective(op, prob.b, prob.x0, method="cg1", max_iter=5)
    assert int(res.niters) == 4


def test_collective_refuses_bf16_and_several_cards(cuda_device):
    """K15/K16 have a bf16 instance now (test_bf16_collective_matches_plain):
    float16, which has none, raises TypeError; so does a mesh across
    cards."""
    _, prob = _sharded(cuda_device, 2, (6, 5, 4), torch.float32)
    op = StencilOperator(6, 5, 4, dtype=torch.float32)
    half = tuple(v.to(torch.float16) for v in prob.b)
    with pytest.raises(TypeError, match="bfloat16"):
        col.cg_collective(op, half, tuple(v.clone() for v in half), max_iter=5)
    if torch.cuda.device_count() > 1:
        other = (prob.b[0], prob.b[1].to("cuda:1"))
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            col.cg_collective(StencilOperator(6, 5, 4, dtype=torch.float32), other, other, max_iter=5)


@pytest.mark.parametrize("backend", ["pallas", "pallas_dd", "pallas_v1", "pallas_fused"])
@pytest.mark.parametrize("method", ["cg", "cg1", "pipecg"])
def test_distributed_kernel_backends_match_stencil(cuda_device, backend, method):
    """The per-iteration kernel backends on four ranks of one card against
    the distributed stencil backend, f64, a tolerance exit."""
    cfg, prob = _sharded(cuda_device, 4, (12, 10, 3), torch.float64)
    mesh = make_mesh(4, devices=[cuda_device] * 4)
    kw = dict(max_iter=500, tolerance=1e-10, method=method)
    ref = make_distributed_cg(cfg, mesh, backend="stencil", **kw)(prob.b, prob.x0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # pallas_fused with cg1/pipecg warns and runs pallas
        res = make_distributed_cg(cfg, mesh, backend=backend, **kw)(prob.b, prob.x0)
    assert int(res.niters) == int(ref.niters) < 499
    rtol, floor = PIPE_TRACE[torch.float64] if method == "pipecg" else (1e-9, 1e-9)
    head = ref.trace > floor * ref.trace[0]
    torch.testing.assert_close(res.trace[head], ref.trace[head], rtol=rtol, atol=0)
    torch.testing.assert_close(torch.cat(res.x), torch.cat(ref.x), rtol=1e-10, atol=0)


@pytest.mark.parametrize("method", ["cg1", "pipecg"])
def test_one_reduction_methods_on_the_card(cuda_device, method):
    """Single-device cg1/pipecg on K1 (pallas) against stencil, f64."""
    prob = generate_problem(ProblemConfig(12, 10, 9), cuda_device)
    ref = make_cg(prob.A, max_iter=500, tolerance=1e-10, backend="stencil", method=method)(prob.b, prob.x0)
    before = st.spmv_stencil.launches
    res = make_cg(prob.A, max_iter=500, tolerance=1e-10, backend="pallas", method=method)(prob.b, prob.x0)
    torch.cuda.synchronize()
    assert st.spmv_stencil.launches > before
    assert int(res.niters) == int(ref.niters) < 499
    rtol, floor = PIPE_TRACE[torch.float64] if method == "pipecg" else (1e-9, 1e-9)
    head = ref.trace > floor * ref.trace[0]
    torch.testing.assert_close(res.trace[head], ref.trace[head], rtol=rtol, atol=0)


def test_distributed_backends_across_cards(cuda_device):
    """One rank per card (needs two or more): the kernel wrappers launch on
    their tensors' card (a launch on the current card with another card's
    stream failed before), and collective refuses a mesh across cards."""
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two or more NVIDIA GPUs")
    cfg = ProblemConfig(12, 10, 3)
    mesh = make_mesh(n)
    prob = generate_problem_sharded(cfg, mesh)
    ref = make_distributed_cg(cfg, mesh, max_iter=500, tolerance=1e-10, backend="stencil")(prob.b, prob.x0)
    for backend in ("pallas", "pallas_dd", "pallas_fused"):
        res = make_distributed_cg(cfg, mesh, max_iter=500, tolerance=1e-10, backend=backend)(prob.b, prob.x0)
        assert int(res.niters) == int(ref.niters) < 499
        assert [x.device for x in res.x] == list(mesh.devices)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_distributed_cg(cfg, mesh, max_iter=5, backend="collective")(prob.b, prob.x0)


# ------------------------------- distributed file mode: K9/K10's window, K17

from hpccg_tpu_torch.models.stencil import Problem  # noqa: E402
from hpccg_tpu_torch.ops.cuda.dia import prepare_dia  # noqa: E402
from hpccg_tpu_torch.parallel import make_collective_dia_cg, shard_problem  # noqa: E402
from hpccg_tpu_torch.parallel.halo import BandStrips  # noqa: E402


def _band_problem(device, n, span, npairs, dtype, ndev, seed=0):
    """A symmetric, diagonally dominant band of offsets 0 and +-o for npairs
    scattered o within (0, span], b = A 1, sharded over ndev ranks of
    ``device``."""
    gen = torch.Generator().manual_seed(seed)
    pos = sorted((torch.randperm(span, generator=gen)[:npairs] + 1).tolist())
    offs = [-o for o in reversed(pos)] + [0] + pos
    data = torch.zeros((len(offs), n), dtype=torch.float64)
    data[npairs] = 2.0 * len(offs)
    for j, o in enumerate(pos):
        v = -0.1 - 0.9 * torch.rand(n - o, generator=gen, dtype=torch.float64)
        data[npairs + 1 + j, : n - o] = v  # A[i, i + o]
        data[npairs - 1 - j, o:] = v  # A[i + o, i]
    A = DiaMatrix(data=data.to(dtype), offsets=tuple(offs), total_nrow=n)
    b = A.matvec(torch.ones(n, dtype=dtype))
    prob = Problem(A=A, b=b, x0=torch.zeros_like(b), xexact=torch.ones_like(b), total_nrow=n, total_nnz_model=0,
                   total_nnz_exact=0)
    return shard_problem(prob, make_mesh(ndev, devices=[device] * ndev))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_dia_window_matches_plain_bit_for_bit(cuda_device, dtype):
    """K9/K10 on each rank's extended vector (the dia-halo tier) against the
    windowed plain version: the same sums and roundings, bit for bit."""
    prob = _band_problem(cuda_device, 4096, 300, 20, dtype, 4)
    blk = prob.A[0]
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    xs = tuple(torch.randn(blk.local_nrow, generator=gen, device=cuda_device, dtype=dtype) for _ in prob.A)
    ext = BandStrips(blk.local_nrow, blk.bw_lo, blk.bw_hi, [cuda_device] * 4, dtype).fill(xs)
    before = _launches(cdia.spmv_dia)
    for blk, x in zip(prob.A, ext):
        P = prepare_dia(blk)
        assert (P.lo, P.xlen) == (blk.bw_lo, blk.bw_lo + blk.local_nrow + blk.bw_hi)
        got, want = cdia.spmv_dia(P, x), cdia.spmv_dia_plain(P, x)
        assert torch.equal(got, want)
    assert _launches(cdia.spmv_dia) == before + 4


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("method", ["cg", "cg1"])
@pytest.mark.parametrize("ndev", [1, 2, 4])
def test_collective_dia_matches_plain(cuda_device, ndev, method, dtype):
    """K17 against its plain version with every rank on one card, a
    symmetric band of +-200 over 1024-row shards: niters equal, the trace within WS_TRACE
    above its floor (the solve stops there, on a tolerance between two of
    the plain trace's entries), x within WS_X_RTOL, one launch per solve,
    two solves bit-identical."""
    prob = _band_problem(cuda_device, 1024 * ndev, 200, 6, dtype, ndev)
    rtol, floor = WS_TRACE[dtype]
    tr = col.solve_plain_dia(prob.A, prob.b, prob.x0, method=method, max_iter=30).trace
    below = torch.nonzero(tr < floor * tr[0])
    tol = 0.0 if below.numel() == 0 else float(torch.sqrt(tr[int(below[0]) - 1] * tr[int(below[0])]))
    want = col.solve_plain_dia(prob.A, prob.b, prob.x0, method=method, max_iter=30, tolerance=tol)
    before = col.cg_collective_dia.launches
    got, again = (col.cg_collective_dia(prob.A, prob.b, prob.x0, method=method, max_iter=30, tolerance=tol)
                  for _ in range(2))
    torch.cuda.synchronize()
    assert col.cg_collective_dia.launches == before + 2
    n = int(want.niters) + 1
    assert int(got.niters) == n - 1
    torch.testing.assert_close(got.trace[:n], want.trace[:n], rtol=rtol, atol=0)
    assert bool(torch.isnan(got.trace[n:]).all())
    _x_close(torch.cat(got.x), torch.cat(want.x))
    assert all(torch.equal(a, b) for a, b in zip(got.x, again.x)) and torch.equal(got.trace[:n], again.trace[:n])


def test_collective_dia_bounded_wait_raises(cuda_device):
    """A 2-rank K17 launch whose waits may last 0 ns gives up at the first
    wait that is not already met: RuntimeError with the error word, no
    hang; the card stays usable. 32768 rows per rank give each rank 32
    blocks, whose rank barriers cannot all be met when first checked (with
    one block per rank every wait can be, and the launch then passed once
    on an H100)."""
    prob = _band_problem(cuda_device, 65536, 200, 6, torch.float32, 2)
    with pytest.raises(RuntimeError, match="gave up after 0 ns"):
        col.launch_dia(prob.A, prob.b, prob.x0, method="cg1", max_iter=30, wait_ns=0)
    torch.cuda.synchronize()
    res = col.cg_collective_dia(prob.A, prob.b, prob.x0, method="cg1", max_iter=5)
    assert int(res.niters) == 4


def test_collective_dia_refuses_bf16_and_several_cards(cuda_device):
    prob = _band_problem(cuda_device, 2048, 200, 6, torch.float32, 2)
    blocks = tuple(dataclasses.replace(blk, data=blk.data.to(torch.bfloat16)) for blk in prob.A)
    bf = tuple(v.to(torch.bfloat16) for v in prob.b)
    with pytest.raises(ValueError, match="bfloat16"):
        col.cg_collective_dia(blocks, bf, bf, max_iter=5)
    if torch.cuda.device_count() > 1:
        mesh = make_mesh(2)
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            make_collective_dia_cg(mesh, max_iter=5)(tuple(blk for blk in prob.A), prob.b, prob.x0)


# ------------------------------------- bf16 K1-K4 and the bandwidth probes

from hpccg_tpu_torch.ops.cuda import stream  # noqa: E402


def _ulps_of_max(got, want) -> float:
    """max|got - want| in bf16 ulps of max|want| (2^-7 of its power of 2)."""
    scale = float(want.float().abs().max()) or 1.0
    ulp = 2.0 ** (int(torch.floor(torch.log2(torch.tensor(scale)))) - 7)
    return float((got.float() - want.float()).abs().max()) / ulp


@pytest.mark.parametrize("stencil", [27, 7])
@pytest.mark.parametrize("dims", [(33, 17, 9), (6, 1, 4), (5, 3, 1)])
def test_bf16_kernels_match_plain(cuda_device, dims, stencil):
    """K1-K4's bf16 instances against their plain versions (f32 compute,
    bf16 storage, f32 partials): vectors within 4 bf16 ulps of max|y|,
    partials within 1e-3, p', x' and r' bit for bit (both round once per
    operation), repeat launches bit-identical."""
    nx, ny, nz = dims
    op = StencilOperator(nx, ny, nz, Stencil(stencil), torch.bfloat16)
    gen = torch.Generator(device=cuda_device).manual_seed(0)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=cuda_device).to(torch.bfloat16)

    u, p, ap = rnd(nz, ny, nx), rnd(nz, ny, nx), rnd(nz, ny, nx)
    h2, h4 = rnd(2, ny, nx), rnd(4, ny, nx)
    beta = torch.tensor([0.37], device=cuda_device)
    before = (st.spmv_stencil.launches_bf16, st.update_p_apply.launches_bf16, fc.update_x_r.launches_bf16)
    for halo in (None, h2):
        y = st.spmv_stencil(op, u, halo)
        assert _ulps_of_max(y, st.spmv_stencil_plain(op, u, halo)) <= 4
        assert torch.equal(y, st.spmv_stencil(op, u, halo))
    y, parts = st.spmv_stencil_pap(op, u, h2)
    y0, parts0 = st.spmv_stencil_pap_plain(op, u, h2)
    assert parts.dtype == torch.float32 and _ulps_of_max(y, y0) <= 4
    torch.testing.assert_close(parts.sum(), parts0.sum(), rtol=1e-3, atol=1e-3)
    for halo in (None, h4):
        pp, app, parts = st.update_p_apply(op, u, p, beta, halo)
        pp0, app0, parts0 = st.update_p_apply_plain(op, u, p, beta, halo)
        assert torch.equal(pp, pp0) and _ulps_of_max(app, app0) <= 4
        torch.testing.assert_close(parts.sum(), parts0.sum(), rtol=1e-3, atol=1e-3)
    x1, r1, x2, r2 = u.clone(), p.clone(), u.clone(), p.clone()
    _, _, parts = fc.update_x_r(x1, r1, ap, u, beta)
    _, _, parts0 = fc.update_x_r_plain(x2, r2, ap, u, beta)
    assert torch.equal(x1, x2) and torch.equal(r1, r2)
    torch.testing.assert_close(parts.sum(), parts0.sum(), rtol=1e-3, atol=0)
    after = (st.spmv_stencil.launches_bf16, st.update_p_apply.launches_bf16, fc.update_x_r.launches_bf16)
    assert [a - b for a, b in zip(after, before)] == [4, 2, 1]
    torch.cuda.synchronize()


def _plain_k1_k4():
    """solver's K1-K4 wrappers swapped for their plain versions (which run
    on CUDA tensors too): the same recurrence and rounding points, no
    kernel. A plain partial lands in slot 0 of the kernel's partials."""
    from unittest import mock

    def into(partials, part):
        if partials is None:
            return part
        partials.zero_()
        partials[:1].copy_(part)
        return partials

    def k2(op, u, halo=None, *, out=None, partials=None, active=None):
        y, part = st.spmv_stencil_pap_plain(op, u, halo, out=out, active=active)
        return y, into(partials, part)

    def k3(op, r, p, beta, halo=None, *, out_p=None, out_ap=None, partials=None, active=None):
        pp, ap, part = st.update_p_apply_plain(op, r, p, beta, halo, out_p=out_p, out_ap=out_ap, active=active)
        return pp, ap, into(partials, part)

    def k4(x, r, p, ap, alpha, *, partials=None, active=None):
        x, r, part = fc.update_x_r_plain(x, r, p, ap, alpha, active=active)
        return x, r, into(partials, part)

    return mock.patch.multiple("hpccg_tpu_torch.solver", spmv_stencil=st.spmv_stencil_plain,
                               spmv_stencil_pap=k2, update_p_apply=k3, update_x_r=k4)


@pytest.mark.parametrize("backend", ["pallas", "pallas_fused", "pallas_v1"])
def test_bf16_kernel_backends_match_plain(cuda_device, backend):
    """bf16 solves on K1-K4 at 32^3 (40 iterations) against the same
    recurrence with the plain versions in place of the kernels: the trace
    within WS_TRACE bf16 (as K5/K6 against theirs); against the bf16 whole
    solve (which rounds at other places: K6 never stores Ap') within 5e-2
    above 1e-3 of trace[0], chip_smoke's bound for two bf16 recurrences;
    pallas_fused launches K3 and K4 once per iteration."""
    prob = generate_problem(ProblemConfig(32, 32, 32, dtype=torch.bfloat16), cuda_device)
    with _plain_k1_k4():
        want = make_cg(prob.A, max_iter=40, tolerance=0.0, backend=backend)(prob.b, prob.x0)
    ref = make_cg(prob.A, max_iter=40, tolerance=0.0, backend="streamkernel")(prob.b, prob.x0)
    before = (st.update_p_apply.launches_bf16, fc.update_x_r.launches_bf16)
    res = make_cg(prob.A, max_iter=40, tolerance=0.0, backend=backend)(prob.b, prob.x0)
    assert int(res.niters) == int(want.niters) == int(ref.niters) == 39 and res.x.dtype == torch.bfloat16
    rtol, floor = WS_TRACE[torch.bfloat16]
    head = want.trace > floor * want.trace[0]
    torch.testing.assert_close(res.trace[head], want.trace[head], rtol=rtol, atol=0)
    head = ref.trace > 1e-3 * ref.trace[0]
    torch.testing.assert_close(res.trace[head], ref.trace[head], rtol=5e-2, atol=0)
    if backend == "pallas_fused":
        assert (st.update_p_apply.launches_bf16 - before[0], fc.update_x_r.launches_bf16 - before[1]) == (39, 39)


def test_probes_match_plain(cuda_device):
    """The copy and write probe kernels bit for bit against their plain
    versions, on lengths with a tail past the last whole float4."""
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    for n in (1, 7, 4096 * 33 + 3):
        x = torch.randn((n,), generator=gen, device=cuda_device)
        before = stream.copy_plus_one.launches
        assert torch.equal(stream.copy_plus_one(x), stream.copy_plus_one_plain(x))
        assert stream.copy_plus_one.launches == before + 1
    seed = torch.randn((512, 128), generator=gen, device=cuda_device)
    for n in (4, 65536 * 3, 65536 * 3 + 5, 1000003):
        before = stream.write_tiled.launches
        assert torch.equal(stream.write_tiled(seed, n), stream.write_tiled_plain(seed, n))
        assert stream.write_tiled.launches == before + 1
    with pytest.raises(ValueError, match="16-byte"):
        stream.copy_plus_one(x[1:])


# ------------------------- bf16 K9/K11 and K15/K16 (vectors bf16, sums f32)

from hpccg_tpu_torch.parallel import cg as pcg  # noqa: E402
from hpccg_tpu_torch.solver import cg_solve  # noqa: E402

BF16 = torch.bfloat16
# K16/bf16 against its plain version: its w and z recurrences carry each
# run's rounding forward, and bf16 pipecg diverges within 10-40 iterations in
# both packages (chip_smoke.py's PIPE_BF16_HEAD and its readings). It is held
# whole on solves of PIPE_BF16_HEAD iterations, and a longer solve over its
# first PIPE_BF16_HEAD trace entries.
PIPE_BF16_HEAD = 5


@pytest.mark.parametrize("case", ["stencil", "stencil_x4", "band", "band_x4", "tiny"])
def test_bf16_dia_kernel_matches_plain(cuda_device, case):
    """K9's bf16 instance against its plain version (float32 sums of exact
    bf16 products, y rounded once): bit for bit, two launches
    bit-identical, counted in launches_bf16 only; the *_x4 cases have a
    multiple of 4 rows (four rows per thread), the others not."""
    if case.startswith("stencil"):
        dims = (32, 16, 9) if case.endswith("x4") else (33, 17, 9)
        D = generate_ell(ProblemConfig(*dims, dtype=BF16), cuda_device).A.to_dia()
    elif case.startswith("band"):
        D = _random_band(5004 if case.endswith("x4") else 5003, 1500, 3000, BF16, cuda_device)
    else:
        D = _random_band(3, 2, 2, BF16, cuda_device)
    P = cdia.prepare_dia(D)
    x = torch.randn(D.local_nrow, device=cuda_device).to(BF16)
    before = (_launches(cdia.spmv_dia), cdia.spmv_dia.launches_bf16)
    y, again = cdia.spmv_dia(P, x), cdia.spmv_dia(P, x)
    torch.cuda.synchronize()
    assert (_launches(cdia.spmv_dia), cdia.spmv_dia.launches_bf16) == (before[0], before[1] + 2)
    assert y.dtype == BF16 and torch.equal(y, cdia.spmv_dia_plain(P, x)) and torch.equal(y, again)


@pytest.mark.parametrize("case", ["stencil", "permuted", "skewed"])
def test_bf16_ell_kernel_matches_plain(cuda_device, case):
    """K11's bf16 instance against its plain version: the float32 products
    summed in slot order, bit for bit (a contracted FMA of an exact product
    rounds as the plain sum does); two launches bit-identical."""
    A = generate_ell(ProblemConfig(12, 10, 9), "cpu").A
    if case == "permuted":
        A = permute_ell(A, torch.randperm(A.local_nrow, generator=torch.Generator().manual_seed(1)).numpy())
    elif case == "skewed":  # one row of 240 slots
        vals, cols, valid = (torch.zeros((A.local_nrow, 240), dtype=t) for t in (A.dtype, torch.int32, torch.bool))
        vals[:, :27], cols[:, :27], valid[:, :27] = A.vals, A.cols, A.valid
        vals[5], cols[5], valid[5] = 0.01, torch.arange(240, dtype=torch.int32) * 4, True
        A = dataclasses.replace(A, vals=vals, cols=cols, valid=valid)
    S = cell.prepare_ell(dataclasses.replace(A, vals=A.vals.to(BF16)).to(cuda_device))
    x = torch.randn(A.local_nrow, device=cuda_device).to(BF16)
    before = cell.spmv_ell.launches_bf16
    y, again = cell.spmv_ell(S, x), cell.spmv_ell(S, x)
    torch.cuda.synchronize()
    assert cell.spmv_ell.launches_bf16 == before + 2
    assert torch.equal(y, cell.spmv_ell_plain(S, x)) and torch.equal(y, again)


def test_bf16_dia_window_matches_plain_bit_for_bit(cuda_device):
    """K9/bf16's window instance on each rank's bf16 extended vector (the
    dia-halo tier), bit for bit, counted in launches_bf16_window; the four
    ranks' rows give the single-device product."""
    prob = _band_problem(cuda_device, 4096, 300, 20, BF16, 4)
    blk = prob.A[0]
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    xs = tuple(torch.randn(blk.local_nrow, generator=gen, device=cuda_device).to(BF16) for _ in prob.A)
    ext = BandStrips(blk.local_nrow, blk.bw_lo, blk.bw_hi, [cuda_device] * 4, BF16).fill(xs)
    before = cdia.spmv_dia.launches_bf16_window
    got = []
    for blk, x in zip(prob.A, ext):
        P = prepare_dia(blk)
        got.append(cdia.spmv_dia(P, x))
        assert torch.equal(got[-1], cdia.spmv_dia_plain(P, x))
    assert cdia.spmv_dia.launches_bf16_window == before + 4
    whole = DiaMatrix(data=torch.cat([blk.data for blk in prob.A], dim=1), offsets=prob.A[0].offsets,
                      total_nrow=4096)
    assert torch.equal(torch.cat(got), cdia.spmv_dia(cdia.prepare_dia(whole), torch.cat(xs)))


def _plain_tier(tier, A, mesh):
    """The sharded A v of a file tier on the rank blocks of A, each rank's
    kernel swapped for its plain version."""
    blocks = pcg.shard_matrix(A, mesh)
    if tier == "ell-allgather":  # each rank's rows on the global x
        slots = [cell.prepare_ell(blk) for blk in blocks]
        return lambda vs: tuple(cell.spmv_ell_plain(S, torch.cat(vs)) for S in slots)
    halo = pcg.HaloTier(blocks, mesh.devices, tier)
    plain = cdia.spmv_dia_plain if tier == "dia-halo" else cell.spmv_ell_plain
    halo.kernels = [(S, plain) for S, _ in halo.kernels]
    return halo


@pytest.mark.parametrize("fmt", ["dia", "ell"])
def test_bf16_explicit_solve_matches_plain(cuda_device, fmt):
    """make_cg on a bf16 matrix on the card (K9/K11 bf16, float32 scalars)
    against the same recurrence on the plain matvec: niters equal, the
    trace within WS_TRACE bf16 above its floor, x as _x_close holds bf16;
    so the bf16 file tiers (dia-halo, ell-halo, ell-allgather on four ranks
    of the card) against the same recurrence on the same shards with the
    plain matvecs, each launching its kernel once per rank and iteration."""
    prob = generate_ell(ProblemConfig(32, 32, 32, dtype=BF16), cuda_device)
    A = prob.A.to_dia() if fmt == "dia" else prob.A
    kernel, prep, plain = ((cdia.spmv_dia, cdia.prepare_dia, cdia.spmv_dia_plain) if fmt == "dia"
                           else (cell.spmv_ell, cell.prepare_ell, cell.spmv_ell_plain))
    P = prep(A)
    want = cg_solve(lambda v: plain(P, v), prob.b, prob.x0, max_iter=40, scalars=torch.float32)
    before = kernel.launches_bf16
    got = make_cg(A, max_iter=40, tolerance=0.0)(prob.b, prob.x0)
    torch.cuda.synchronize()
    assert kernel.launches_bf16 - before == 40 and int(got.niters) == int(want.niters) == 39
    rtol, floor = WS_TRACE[BF16]
    head = want.trace > floor * want.trace[0]
    torch.testing.assert_close(got.trace[head], want.trace[head], rtol=rtol, atol=0)
    _x_close(got.x, want.x)
    mesh = make_mesh(4, devices=[cuda_device] * 4)
    sp = shard_problem(dataclasses.replace(prob, A=A), mesh)
    tiers = ([(pcg.make_distributed_dia_cg, "dia-halo")] if fmt == "dia"
             else [(pcg.make_distributed_ell_halo_cg, "ell-halo"), (pcg.make_distributed_ell_cg, "ell-allgather")])
    for make, tier in tiers:
        want = cg_solve(_plain_tier(tier, sp.A, mesh), sp.b, sp.x0, max_iter=20, scalars=torch.float32)
        before = kernel.launches_bf16
        res = make(mesh, max_iter=20)(sp.A, sp.b, sp.x0)
        torch.cuda.synchronize()
        assert kernel.launches_bf16 - before == 4 * 20 and int(res.niters) == int(want.niters) == 19
        head = want.trace > floor * want.trace[0]
        torch.testing.assert_close(res.trace[head], want.trace[head], rtol=rtol, atol=0)
        _x_close(torch.cat(res.x), torch.cat(want.x))


@pytest.mark.parametrize("method", ["cg", "cg1", "pipecg"])
@pytest.mark.parametrize("ndev", [1, 4])
def test_bf16_collective_matches_plain(cuda_device, ndev, method):
    """K15/K16's bf16 instance (bf16 vectors and landing planes, float32
    partials, table, scalars and trace) against its plain version with
    every rank on one card, 30 iterations: niters equal, the trace within
    WS_TRACE bf16 above its floor and x as _x_close holds bf16; pipecg so
    on a solve of PIPE_BF16_HEAD iterations, and over its first
    PIPE_BF16_HEAD trace entries on the 30. One launch per solve counted in
    launches_bf16, two solves bit-identical."""
    _, prob = _sharded(cuda_device, ndev, (33, 17, 9), BF16)
    op = StencilOperator(33, 17, 9, dtype=BF16)
    kern = col.cg_collective_pipelined if method == "pipecg" else col.cg_collective
    kw = {} if method == "pipecg" else {"method": method}
    rtol, floor = WS_TRACE[BF16]
    for iters in (PIPE_BF16_HEAD, 30) if method == "pipecg" else (30,):
        want = col.solve_plain(op, prob.b, prob.x0, method=method, max_iter=iters)
        before = kern.launches_bf16
        got, again = (kern(op, prob.b, prob.x0, max_iter=iters, **kw) for _ in range(2))
        torch.cuda.synchronize()
        assert kern.launches_bf16 == before + 2 and got.trace.dtype == torch.float32
        assert int(got.niters) == int(want.niters) == iters - 1
        whole = method != "pipecg" or iters <= PIPE_BF16_HEAD
        head = want.trace > floor * want.trace[0]
        head[PIPE_BF16_HEAD if not whole else iters:] = False
        torch.testing.assert_close(got.trace[head], want.trace[head], rtol=rtol, atol=0)
        if whole:
            _x_close(torch.cat(got.x), torch.cat(want.x))
        assert all(torch.equal(a, b) for a, b in zip(got.x, again.x)) and torch.equal(got.trace, again.trace)
