"""The CUDA kernels against their plain torch versions, on the card.

Every test here is marked ``cuda`` and skips without an NVIDIA GPU. The file
imports torch only, so that the machine with the card, which has no jax,
runs it without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py

Tolerances as in test_torch_kernels.py (max |kernel - plain| over max |plain|
for vectors, relative for dots): f64 1e-13 / 1e-12, f32 1e-5 / 1e-4. The
whole-solve kernels K5/K6 against their plain versions, at 33x17x9,
200x170x150 and 300x301x250 (more work items than blocks, so blocks take
several in turns), at the edges of their tile and on b and x0 views at odd
element offsets:
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


# a grid with more work items than the cooperative grid has blocks in every
# dtype, so that blocks take several items in turns (33x17x9 and
# 200x170x150 give each block one)
WS_MULTI = (300, 301, 250)


def _kernel_pair(which):
    return ((mk.cg_solve_mega, mk.cg_solve_mega_plain) if which == "mega"
            else (sk.cg_solve_stream, sk.cg_solve_stream_plain))


def _whole_solve_case(which, A, b, x0, dtype):
    """K5 or K6 against its plain version on (A, b, x0), max_iter 30,
    stopped by a tolerance between the two plain trace entries that
    straddle WS_TRACE's floor: niters equal, the trace within its rtol, x as
    _x_close holds it, one launch per solve, two solves bit-identical."""
    kern, plain = _kernel_pair(which)
    rtol, floor = WS_TRACE[dtype]
    tr = plain(A, b, x0, max_iter=30).trace
    below = torch.nonzero(tr < floor * tr[0])
    tol = 0.0 if below.numel() == 0 else float(torch.sqrt(tr[int(below[0]) - 1] * tr[int(below[0])]))
    want = plain(A, b, x0, max_iter=30, tolerance=tol)
    before = kern.launches
    got, again = (kern(A, b, x0, max_iter=30, tolerance=tol) for _ in range(2))
    torch.cuda.synchronize()
    assert kern.launches == before + 2
    n = int(want.niters) + 1
    assert int(got.niters) == n - 1
    assert got.x.dtype == dtype and got.trace.dtype == want.trace.dtype
    torch.testing.assert_close(got.trace[:n], want.trace[:n], rtol=rtol, atol=0)
    assert bool(torch.isnan(got.trace[n:]).all())
    _x_close(got.x, want.x)
    assert torch.equal(got.x, again.x) and torch.equal(got.trace[:n], again.trace[:n])


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32, torch.bfloat16])
@pytest.mark.parametrize("stencil", [27, 7])
@pytest.mark.parametrize("which", ["mega", "stream"])
@pytest.mark.parametrize("dims", [(33, 17, 9), (200, 170, 150), WS_MULTI],
                         ids=["33x17x9", "200x170x150", "300x301x250"])
def test_whole_solve_matches_plain(cuda_device, dims, which, stencil, dtype):
    from hpccg_tpu_torch.ops.cuda import wholesolve

    prob = generate_problem(ProblemConfig(*dims, stencil=stencil, dtype=dtype), cuda_device)
    if dims == WS_MULTI:
        stream = which == "stream"
        assert wholesolve.work_items(prob.A, dtype, stream) > wholesolve.num_blocks(prob.A, dtype, stream)
    _whole_solve_case(which, prob.A, prob.b, prob.x0, dtype)


WS_EDGES = ["nx<V", "nx=100", "nx=TX-1", "nx=TX+1", "ny%TY", "nz=ZC-1", "nz=ZC+1"]


def _ws_edge_shape(edge, dtype, stencil, recompute_ap):
    """(nx, ny, nz) at ``edge`` of the whole-solve kernel's geometry for
    ``dtype``: a thread's V points (16 bytes), the tile's width TX = 32 V
    and height TY, and its z chunk ZC. The kernel picks ZC per grid, so
    the z edges are grids whose chosen chunk is one above or one below
    their nz, the largest chunk for which the search finds one."""
    from hpccg_tpu_torch.ops.cuda import wholesolve

    def geo(nx, ny, nz):
        return wholesolve.geometry(StencilOperator(nx, ny, nz, Stencil(stencil), dtype), dtype, recompute_ap)

    g = geo(64, 64, 64)
    tx, ty = g.tile_x, g.tile_y
    shapes = {"nx<V": (max(tx // 32 - 1, 1), ty + 3, 5), "nx=100": (100, ty + 3, 7), "nx=TX-1": (tx - 1, ty + 1, 6),
              "nx=TX+1": (tx + 1, 2 * ty + 1, 5), "ny%TY": (33, 3 * ty + 5, 9)}
    if edge in shapes:
        return shapes[edge]
    zc = geo(tx * 8, ty * 128, 4096).z_chunk
    while zc >= 2:
        nz = zc - 1 if edge == "nz=ZC-1" else zc + 1
        for ky in range(1, 4096):
            if geo(tx + 1, ty * ky + 1, nz).z_chunk == zc:
                return tx + 1, ty * ky + 1, nz
        zc //= 2
    raise AssertionError(f"no grid at {edge}")


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32, torch.bfloat16])
@pytest.mark.parametrize("stencil", [27, 7])
@pytest.mark.parametrize("which", ["mega", "stream"])
@pytest.mark.parametrize("edge", WS_EDGES)
def test_whole_solve_at_tile_edges(cuda_device, edge, which, stencil, dtype):
    """K5/K6 against their plain versions on grids at the edges of their
    tile (_ws_edge_shape), with the limits of test_whole_solve_matches_plain."""
    dims = _ws_edge_shape(edge, dtype, stencil, which == "stream")
    prob = generate_problem(ProblemConfig(*dims, stencil=stencil, dtype=dtype), cuda_device)
    _whole_solve_case(which, prob.A, prob.b, prob.x0, dtype)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32, torch.bfloat16])
@pytest.mark.parametrize("which", ["mega", "stream"])
def test_whole_solve_on_unaligned_views(cuda_device, which, dtype):
    """K5/K6 with b and x0 views at odd element offsets (1 and 3), which
    init stages and reads on narrower accesses: on a random x0 the same
    bits as on aligned copies of the same values (niters, trace and x),
    and on the problem's own b and x0 the plain version's result as in
    test_whole_solve_matches_plain."""
    prob = generate_problem(ProblemConfig(100, 9, 7, dtype=dtype), cuda_device)
    n = prob.b.numel()
    gen = torch.Generator(device=cuda_device).manual_seed(9)

    def view(t, offset):
        out = _at(n, offset, gen, cuda_device, dtype)
        return out if t is None else out.copy_(t)

    b, x0 = view(prob.b, 1), view(None, 3)
    assert b.data_ptr() % 16 != 0 and x0.data_ptr() % 16 != 0
    kern, _ = _kernel_pair(which)
    got, want = kern(prob.A, b, x0, max_iter=30), kern(prob.A, b.clone(), x0.clone(), max_iter=30)
    assert int(got.niters) == int(want.niters)
    assert torch.equal(got.x, want.x) and torch.equal(got.trace[: int(got.niters) + 1], want.trace[: int(got.niters) + 1])
    _whole_solve_case(which, prob.A, view(prob.b, 1), view(prob.x0, 3), dtype)


@pytest.mark.parametrize("which", ["mega", "stream"])
def test_whole_solve_plain_is_the_same_on_card_and_cpu(cuda_device, which):
    """The plain version, which the card holds K5/K6 against, gives the same
    bits on the card as on the CPU, where the CPU tests hold it against the
    JAX kernels: bf16 at 257x465x17, 30 iterations, where float32
    torch.dot sums parted the two in 14% of x (PERF.md)."""
    _, plain = _kernel_pair(which)
    prob = generate_problem(ProblemConfig(257, 465, 17, dtype=torch.bfloat16), cuda_device)
    card = plain(prob.A, prob.b, prob.x0, max_iter=30)
    cpu = plain(prob.A, prob.b.cpu(), prob.x0.cpu(), max_iter=30)
    assert int(card.niters) == int(cpu.niters) == 29
    assert torch.equal(card.trace.cpu(), cpu.trace) and torch.equal(card.x.cpu(), cpu.x)


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
from hpccg_tpu_torch.operators import DiaMatrix, EllMatrix  # noqa: E402
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


def _scatter_matrix(case, dtype, device):
    """A wide scatter on ``device``: a randomly permuted 48^3 stencil (x of
    442 kB in float32) or 100^3 stencil (x of 4 MB), or a random band of n =
    10^6 within +-3*10^5 (K14's class)."""
    if case != "band":
        g = 48 if case == "permuted" else 100
        A = generate_ell(ProblemConfig(g, g, g, dtype=dtype), "cpu").A
        return permute_ell(A, torch.randperm(A.local_nrow, generator=torch.Generator().manual_seed(3)).numpy()
                           ).to(device)
    n, bw = 1_000_000, 300_000
    gen = torch.Generator().manual_seed(4)
    rows = torch.arange(n)[:, None]
    cols = (rows + torch.randint(-bw, bw + 1, (n, 9), generator=gen)).clamp_(0, n - 1)
    cols[:, 0] = rows[:, 0]
    vals = torch.rand((n, 9), generator=gen, dtype=dtype) * 0.9 - 1.0
    vals[:, 0] = 10.0
    valid = torch.rand((n, 9), generator=gen) >= 0.15
    valid[:, 0] = True
    return EllMatrix(vals=torch.where(valid, vals, 0).to(device),
                     cols=torch.where(valid, cols, 0).to(torch.int32).to(device), valid=valid.to(device),
                     start_row=0, total_nrow=n)


def _scatter_launches() -> int:
    return cell.spmv_ell.launches_scatter_f32 + cell.spmv_ell.launches_scatter_f64


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("form", ["relabelled", "in place"])
@pytest.mark.parametrize("case", ["permuted", "band", "large x"])
def test_scatter_kernel_matches_plain_and_k11(cuda_device, case, form, dtype):
    """The wide-scatter classes in both forms, relabelled (K13's kernel, in
    the stencils' RCM order, a random order for the band) and in place
    (K11/K12): within 1e-13 / 1e-5 of
    max|y| of the form's plain version, bit for bit K11/K12's launch on the
    same matrix (the same sums in the same order), two launches
    bit-identical; each form's launches are counted on its own counters per
    dtype. The chooser relabels the permuted stencils and keeps the random
    band (K14's class) on K11/K12."""
    from hpccg_tpu_torch.reorder import rcm_permutation

    A = _scatter_matrix(case, dtype, cuda_device)
    relabel = form == "relabelled"
    # any order holds the kernel to K11's bits; a random one spares the band the host's RCM
    perm = torch.randperm(A.local_nrow).numpy() if case == "band" else rcm_permutation(A)
    S = cell.prepare_scatter(A, perm) if relabel else cell.ell_slots(A)
    chosen = cell.prepare_ell(A)
    assert type(chosen) is (cell.EllSlots if case == "band" else cell.ScatterEll)
    x = torch.randn(A.local_nrow, dtype=dtype, device=cuda_device)
    want = cell.spmv_ell(cell.ell_slots(A), x)
    before, k11 = _scatter_launches(), _launches(cell.spmv_ell)
    y, again = cell.spmv_ell(S, x), cell.spmv_ell(S, x)
    torch.cuda.synchronize()
    assert _scatter_launches() == before + 2 * relabel
    assert _launches(cell.spmv_ell) == k11 + 2 * (not relabel)
    if relabel:
        attr = "launches_scatter_f32" if dtype == torch.float32 else "launches_scatter_f64"
        assert getattr(cell.spmv_ell, attr) >= 2
    _vec(y, cell.spmv_ell_plain(S, x))
    assert torch.equal(y, want) and torch.equal(y, again)


def test_scatter_kernel_on_rank_blocks(cuda_device):
    """A rank's rows of a permuted matrix with global columns (ncols != n,
    the ell-allgather tier's blocks) stay on K11's layout, gathered in
    place; the relabelled layout needs the square matrix. On x views at an
    odd element offset, bit for bit K11's launch on the block."""
    from hpccg_tpu_torch.parallel import cg as pcg

    A = _scatter_matrix("permuted", torch.float32, cuda_device)
    n = A.local_nrow
    for blk in pcg.shard_matrix(A, make_mesh(4, devices=[cuda_device] * 4)):
        S = cell.prepare_ell(blk)
        assert type(S) is cell.EllSlots and S.ncols == n != S.local_nrow
        with pytest.raises(ValueError, match="square"):
            cell.prepare_scatter(blk, torch.arange(blk.local_nrow).numpy())
        x = torch.randn(n + 1, device=cuda_device)[1:]
        y, again = cell.spmv_ell(S, x), cell.spmv_ell(S, x)
        torch.cuda.synchronize()
        _vec(y, cell.spmv_ell_plain(S, x))
        assert torch.equal(y, again)


def test_scatter_solve_runs_its_kernel(cuda_device):
    """make_cg on the permuted 48^3 stencil as loaded launches K13/K14's
    kernel once per matvec, and the solve gives the bits of the same solve
    on K11's layout (the matvecs agree bit for bit)."""
    prob = generate_ell(ProblemConfig(48, 48, 48), "cpu")
    perm = torch.randperm(prob.total_nrow, generator=torch.Generator().manual_seed(3))
    A = permute_ell(prob.A, perm.numpy()).to(cuda_device)
    b, x0 = prob.b[perm].to(cuda_device), prob.x0[perm].to(cuda_device)
    before = cell.spmv_ell.launches_scatter_f64
    res = make_cg(A, max_iter=30, tolerance=0.0)(b, x0)
    torch.cuda.synchronize()
    assert cell.spmv_ell.launches_scatter_f64 - before >= 30
    from hpccg_tpu_torch.solver import cg_solve
    from hpccg_tpu_torch.config import scalar_dtype

    ref = cg_solve(cell.ell_slots(A).matvec, b, x0, scalars=scalar_dtype(A.dtype), max_iter=30, tolerance=0.0)
    assert int(res.niters) == int(ref.niters) == 29
    assert torch.equal(res.trace, ref.trace) and torch.equal(res.x, ref.x)


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
    float16, which has none, raises TypeError. Across cards they run
    (test_collective_across_cards_matches_one_card), but refuse shards whose
    rank's b and x0 lie on two cards, and a card whose ranks are not
    consecutive: ValueError."""
    _, prob = _sharded(cuda_device, 2, (6, 5, 4), torch.float32)
    op = StencilOperator(6, 5, 4, dtype=torch.float32)
    half = tuple(v.to(torch.float16) for v in prob.b)
    with pytest.raises(TypeError, match="bfloat16"):
        col.cg_collective(op, half, tuple(v.clone() for v in half), max_iter=5)
    if torch.cuda.device_count() > 1:
        other = (prob.b[0], prob.b[1].to("cuda:1"))
        with pytest.raises(ValueError, match="one card"):
            col.cg_collective(op, other, (prob.x0[0], prob.x0[1].clone()), max_iter=5)
        apart = tuple(v.to(d) for v, d in zip(prob.b + prob.b[:1], ("cuda:0", "cuda:1", "cuda:0")))
        with pytest.raises(ValueError, match="not consecutive"):
            col.cg_collective(op, apart, tuple(v.clone() for v in apart), max_iter=5)


def _cards(count: int):
    if torch.cuda.device_count() < count:
        pytest.skip(f"needs {count} NVIDIA GPUs")
    return [torch.device("cuda", i) for i in range(count)]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("method", ["cg", "cg1", "pipecg"])
@pytest.mark.parametrize("cards", ["2", "all"])
def test_collective_across_cards_matches_one_card(cuda_device, cards, method, dtype):
    """The same ranks launched one per card (the system-scope instance, one
    launch per card) and all on cuda:0 (one launch): niters equal, the trace
    and x within 1e-12 relative (the dots are summed in the same order, so
    they agree to the bit), one launch counted per card, x on its rank's
    card; 64^3 per rank, 40 iterations."""
    devices = _cards(2 if cards == "2" else max(torch.cuda.device_count(), 2))
    ndev = len(devices)
    cfg = ProblemConfig(64, 64, 64, dtype=dtype)
    one = generate_problem_sharded(cfg, make_mesh(ndev, devices=[devices[0]] * ndev))
    spread = make_mesh(devices=devices)
    b, x0 = tuple(v.to(d) for v, d in zip(one.b, devices)), tuple(v.to(d) for v, d in zip(one.x0, devices))
    kw = dict(max_iter=40, backend="collective", method=method)
    want = make_distributed_cg(cfg, make_mesh(ndev, devices=[devices[0]] * ndev), **kw)(one.b, one.x0)
    kern = col.cg_collective_pipelined if method == "pipecg" else col.cg_collective
    before = kern.launches
    got = make_distributed_cg(cfg, spread, **kw)(b, x0)
    for d in devices:
        torch.cuda.synchronize(d)
    assert kern.launches == before + ndev
    assert int(got.niters) == int(want.niters) == 39
    torch.testing.assert_close(got.trace, want.trace, rtol=1e-12, atol=0, equal_nan=True)
    assert [x.device for x in got.x] == devices
    torch.testing.assert_close(torch.cat([x.to(devices[0]) for x in got.x]), torch.cat(want.x), rtol=1e-12, atol=0)


def test_collective_across_cards_reuses_its_set_up_and_times_its_waits(cuda_device):
    """make_distributed_cg sets a mesh across cards up once (one
    ``collective.peer_setup`` span) and issues each solve in one
    ``collective.issue`` span; with tracing on each rank's block 0 reports
    its wait on peers and its kernel time, wait below kernel; off, nothing
    is recorded. Solves repeat to the bit."""
    from hpccg_tpu_torch.utils import trace

    devices = _cards(2)
    cfg = ProblemConfig(32, 32, 16)
    mesh = make_mesh(devices=devices)
    prob = generate_problem_sharded(cfg, mesh)
    solve = make_distributed_cg(cfg, mesh, max_iter=30, backend="collective", method="cg")
    col._plan = None  # no mesh set up before
    trace.take(), trace.take_counts()
    trace.enable()
    try:
        runs = [solve(prob.b, prob.x0) for _ in range(3)]
    finally:
        trace.disable()
    spans, counts = trace.take(), trace.take_counts()
    assert [s.name for s in spans] == ["collective.peer_setup"] + ["collective.issue"] * 3
    waits = [c.value for c in counts if c.name == "collective.wait_ns"]
    kernels = [c.value for c in counts if c.name == "collective.kernel_ns"]
    assert len(waits) == len(kernels) == 3 * len(devices)
    assert all(0 <= w < k for w, k in zip(waits, kernels))
    assert all(torch.equal(a, b) for r in runs[1:] for a, b in zip(r.x, runs[0].x))
    solve(prob.b, prob.x0)
    assert trace.take() == [] and trace.take_counts() == []


def test_collective_across_cards_bounded_wait_raises(cuda_device):
    """Across two cards with waits of 0 ns: RuntimeError with the error
    word, no hang; both cards stay usable."""
    devices = _cards(2)
    cfg = ProblemConfig(33, 17, 9, dtype=torch.float32)
    prob = generate_problem_sharded(cfg, make_mesh(devices=devices))
    op = StencilOperator(33, 17, 9, dtype=torch.float32)
    with pytest.raises(RuntimeError, match="gave up after 0 ns"):
        col.launch(op, prob.b, prob.x0, method="cg1", max_iter=30, wait_ns=0)
    for d in devices:
        torch.cuda.synchronize(d)
    res = col.cg_collective(op, prob.b, prob.x0, method="cg1", max_iter=5)
    assert int(res.niters) == 4


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
    stream failed before), and collective runs the mesh across cards, one
    launch per card."""
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
    for method in ("cg", "cg1"):
        kw = dict(max_iter=500, tolerance=1e-10, method=method)
        want = make_distributed_cg(cfg, mesh, backend="stencil", **kw)(prob.b, prob.x0)
        res = make_distributed_cg(cfg, mesh, backend="collective", **kw)(prob.b, prob.x0)
        assert int(res.niters) == int(want.niters) < 499
        assert [x.device for x in res.x] == list(mesh.devices)
        torch.testing.assert_close(torch.cat([x.to(mesh.devices[0]) for x in res.x]),
                                   torch.cat([x.to(mesh.devices[0]) for x in want.x]), rtol=1e-8, atol=0)


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


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("extra, ndev", [(-1, 1), (0, 2), (1, 4), (3, 6), (8192, 4)])
def test_collective_dia_apply_is_dia_rows_matvec(cuda_device, extra, ndev, dtype):
    """K17's apply bit for bit against DiaRows.matvec over BandStrips: a cg
    launch of one iteration leaves p and A p, as the kernel computed it, in
    the launch's state. Shards of one row below, at, one above and three
    above K17's tile (an odd L reads the data directly, an even one through
    the ring) and of eight tiles and more (inner tiles, several per block)."""
    tile = col.dia_tile_rows(dtype)
    L = tile + extra
    prob = _band_problem(cuda_device, L * ndev, 200, 6, dtype, ndev)
    _, scratch = col.launch_dia(prob.A, prob.b, prob.x0, method="cg", max_iter=2)
    state, kinds = scratch.state, col.VECTORS["cg"]
    p, ap = state[kinds.index(col.P_P)], state[kinds.index(col.P_S)]
    blk = prob.A[0]
    ext = BandStrips(L, blk.bw_lo, blk.bw_hi, [cuda_device] * ndev, dtype).fill(tuple(p[r] for r in range(ndev)))
    for r, (blk, x) in enumerate(zip(prob.A, ext)):
        assert torch.equal(ap[r], blk.matvec(x)), r


@pytest.mark.parametrize("method", ["cg", "cg1"])
def test_collective_dia_f64_off_the_current_card(cuda_device, method):
    """K17 in float64 (its ring's 64 KB of shared memory is above the 48 KB
    a kernel gets unless it asks) with the shards on the second card while
    the first is current: the grid is sized, and the attribute set, on the
    shards' card, and the solve is the first card's bit for bit."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two NVIDIA GPUs")
    want = _band_problem(torch.device("cuda:0"), 2 * 4096, 200, 6, torch.float64, 2)
    prob = _band_problem(torch.device("cuda:1"), 2 * 4096, 200, 6, torch.float64, 2)
    with torch.cuda.device(0):
        got = col.cg_collective_dia(prob.A, prob.b, prob.x0, method=method, max_iter=20)
        ref = col.cg_collective_dia(want.A, want.b, want.x0, method=method, max_iter=20)
    assert got.x[0].device == torch.device("cuda:1") and int(got.niters) == int(ref.niters)
    assert torch.equal(got.trace.cpu(), ref.trace.cpu())
    assert all(torch.equal(a.cpu(), b.cpu()) for a, b in zip(got.x, ref.x))


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

    def k3(op, r, p, beta, halo=None, *, out_p=None, out_ap=None, partials=None, active=None, store_ap=True):
        pp, ap, part = st.update_p_apply_plain(op, r, p, beta, halo, out_p=out_p, out_ap=out_ap, active=active,
                                               store_ap=store_ap)
        return pp, ap, into(partials, part)

    def k4(x, r, p, ap, alpha, *, partials=None, active=None):
        x, r, part = fc.update_x_r_plain(x, r, p, ap, alpha, active=active)
        return x, r, into(partials, part)

    def k4s(op, x, r, p, alpha, *, partials=None, active=None):
        x, r, part = st.update_x_r_stencil_plain(op, x, r, p, alpha, active=active)
        return x, r, into(partials, part)

    return mock.patch.multiple("hpccg_tpu_torch.solver", spmv_stencil=st.spmv_stencil_plain,
                               spmv_stencil_pap=k2, update_p_apply=k3, update_x_r=k4, update_x_r_stencil=k4s)


@pytest.mark.parametrize("backend", ["pallas", "pallas_fused", "pallas_v1"])
def test_bf16_kernel_backends_match_plain(cuda_device, backend):
    """bf16 solves on K1-K4 at 32^3 (40 iterations) against the same
    recurrence with the plain versions in place of the kernels: the trace
    within WS_TRACE bf16 (as K5/K6 against theirs); against the bf16 whole
    solve (which rounds at other places: K6 never stores Ap') within 5e-2
    above 1e-3 of trace[0], chip_smoke's bound for two bf16 recurrences;
    pallas_fused launches K3 and K4s once per iteration."""
    prob = generate_problem(ProblemConfig(32, 32, 32, dtype=torch.bfloat16), cuda_device)
    with _plain_k1_k4():
        want = make_cg(prob.A, max_iter=40, tolerance=0.0, backend=backend)(prob.b, prob.x0)
    ref = make_cg(prob.A, max_iter=40, tolerance=0.0, backend="streamkernel")(prob.b, prob.x0)
    before = (st.update_p_apply.launches_bf16, st.update_x_r_stencil.launches_bf16)
    res = make_cg(prob.A, max_iter=40, tolerance=0.0, backend=backend)(prob.b, prob.x0)
    assert int(res.niters) == int(want.niters) == int(ref.niters) == 39 and res.x.dtype == torch.bfloat16
    rtol, floor = WS_TRACE[torch.bfloat16]
    head = want.trace > floor * want.trace[0]
    torch.testing.assert_close(res.trace[head], want.trace[head], rtol=rtol, atol=0)
    head = ref.trace > 1e-3 * ref.trace[0]
    torch.testing.assert_close(res.trace[head], ref.trace[head], rtol=5e-2, atol=0)
    if backend == "pallas_fused":
        assert (st.update_p_apply.launches_bf16 - before[0],
                st.update_x_r_stencil.launches_bf16 - before[1]) == (39, 39)


# ----------------------------- K1-K4 at the edges of the stencil kernels' tile

EDGES = ["nx<V", "nx=100", "nx=TX-1", "nx=TX+1", "ny%TY", "nz<ZC", "nz=ZC+1"]


def _edge_shape(edge, dtype):
    """(nx, ny, nz) that puts the grid at ``edge`` of the stencil kernels'
    geometry for ``dtype``: a thread's V points (16 bytes), the tile's width
    TX = 32 V and height TY, and the largest z chunk ZC (the grids of the
    last two have enough xy tiles that the kernel keeps ZC; checked)."""
    geo = st.tile_geometry(64, 64, 64, dtype)
    tx, ty = geo.tile_x, geo.tile_y
    v = tx // 32
    shapes = {"nx<V": (max(v - 1, 1), ty + 3, 5), "nx=100": (100, ty + 3, 7), "nx=TX-1": (tx - 1, ty + 1, 6),
              "nx=TX+1": (tx + 1, 2 * ty + 1, 5), "ny%TY": (33, 3 * ty + 5, 9)}
    if edge in shapes:
        return shapes[edge]
    zmax = st.tile_geometry(tx * 8, ty * 128, 4096, dtype).z_chunk
    nz = zmax - 1 if edge == "nz<ZC" else zmax + 1
    for k in (16, 32, 64, 128, 256, 512, 1024):
        dims = (tx + 1, ty * k + 1, nz)
        if st.tile_geometry(*dims, dtype).z_chunk == zmax:
            return dims
    raise AssertionError(f"no grid keeps the z chunk at {zmax}")


def _close(got, want, dtype):
    """A product against its plain version: within VEC_RTOL of max|want|
    (float32/float64; the kernels' sums contract into FMAs where the plain
    version does not), or 4 bf16 ulps of max|want| (bf16)."""
    if dtype == torch.bfloat16:
        assert _ulps_of_max(got, want) <= 4
    else:
        _vec(got, want)


def _sum_close(got, want, dtype):
    if dtype == torch.bfloat16:
        torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-3)
    else:
        _dot(got, want)


def _k1_k4(op, u, p, ap, h2, h4, beta, dtype):
    """K1-K4 on these inputs, each held against its plain version (p', x'
    and r' bit for bit, as both round once per operation); returns every
    output and partial, for a repeat to compare bit for bit."""
    outs = []
    for halo in (None, h2):
        y = st.spmv_stencil(op, u, halo)
        _close(y, st.spmv_stencil_plain(op, u, halo), dtype)
        y2, parts = st.spmv_stencil_pap(op, u, halo)
        y0, parts0 = st.spmv_stencil_pap_plain(op, u, halo)
        _close(y2, y0, dtype)
        _sum_close(parts.sum(), parts0.sum(), dtype)
        outs += [y, y2, parts]
    for halo in (None, h4):
        pp, app, parts = st.update_p_apply(op, u, p, beta, halo)
        pp0, app0, parts0 = st.update_p_apply_plain(op, u, p, beta, halo)
        assert torch.equal(pp, pp0)
        _close(app, app0, dtype)
        _sum_close(parts.sum(), parts0.sum(), dtype)
        outs += [pp, app, parts]
    x1, r1, x2, r2 = u.clone(), p.clone(), u.clone(), p.clone()
    _, _, parts = fc.update_x_r(x1, r1, ap, u, beta)
    _, _, parts0 = fc.update_x_r_plain(x2, r2, ap, u, beta)
    assert torch.equal(x1, x2) and torch.equal(r1, r2)
    _sum_close(parts.sum(), parts0.sum(), dtype)
    return outs + [x1, r1, parts]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32, torch.bfloat16])
@pytest.mark.parametrize("stencil", [27, 7])
@pytest.mark.parametrize("edge", EDGES)
def test_kernels_match_plain_at_tile_edges(cuda_device, edge, stencil, dtype):
    """K1-K4 (and K7, K2's float64 instance) against their plain versions on
    grids at the edges of the stencil kernels' tile (_edge_shape), with and
    without halo planes; a second launch of each gives the same bits,
    partials included."""
    nx, ny, nz = _edge_shape(edge, dtype)
    op = StencilOperator(nx, ny, nz, Stencil(stencil), dtype)
    gen = torch.Generator(device=cuda_device).manual_seed(1)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=cuda_device, dtype=torch.float64).to(dtype)

    u, p, ap = rnd(nz, ny, nx), rnd(nz, ny, nx), rnd(nz, ny, nx)
    h2, h4 = rnd(2, ny, nx), rnd(4, ny, nx)
    beta = torch.tensor([0.37], device=cuda_device, dtype=torch.float64 if dtype == torch.float64 else torch.float32)
    first = _k1_k4(op, u, p, ap, h2, h4, beta, dtype)
    again = _k1_k4(op, u, p, ap, h2, h4, beta, dtype)
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    if dtype == torch.float64:
        y, parts = st.spmv_stencil_pap_dd(op, u, h2)
        y0, parts0 = st.spmv_stencil_pap_plain(op, u, h2)
        _vec(y, y0)
        _dot(parts.sum(), parts0.sum())
    torch.cuda.synchronize()


def _at(n, offset, gen, device, dtype):
    """A contiguous vector of n elements that starts ``offset`` elements
    into its storage (a view at that element offset)."""
    return torch.randn((n + offset,), generator=gen, device=device, dtype=torch.float64).to(dtype)[offset:]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32, torch.bfloat16])
def test_kernels_on_unaligned_views(cuda_device, dtype):
    """Each of K1-K4 on vectors that are views at odd element offsets
    (inputs, outputs and halo planes), so that no 16-byte access lines up:
    the kernels take narrower accesses and match their plain versions
    (p', x', r' bit for bit). K4 also with the four arrays at different
    offsets (no common 16-byte boundary: every element alone)."""
    nx, ny, nz = 100, 9, 7
    n = nx * ny * nz
    op = StencilOperator(nx, ny, nz, Stencil.S27, dtype)
    gen = torch.Generator(device=cuda_device).manual_seed(2)

    def grid(offset):
        return _at(n, offset, gen, cuda_device, dtype).view(nz, ny, nx)

    u, p, ap = grid(1), grid(3), grid(5)
    h2 = _at(2 * ny * nx, 1, gen, cuda_device, dtype).view(2, ny, nx)
    h4 = _at(4 * ny * nx, 3, gen, cuda_device, dtype).view(4, ny, nx)
    beta = torch.tensor([0.37], device=cuda_device, dtype=torch.float64 if dtype == torch.float64 else torch.float32)
    for halo in (None, h2):
        out = grid(1)
        st.spmv_stencil(op, u, halo, out=out)
        _close(out, st.spmv_stencil_plain(op, u, halo), dtype)
        y, parts = st.spmv_stencil_pap(op, u, halo, out=grid(7))
        y0, parts0 = st.spmv_stencil_pap_plain(op, u, halo)
        _close(y, y0, dtype)
        _sum_close(parts.sum(), parts0.sum(), dtype)
    for halo in (None, h4):
        pp, app, parts = st.update_p_apply(op, u, p, beta, halo, out_p=grid(3), out_ap=grid(1))
        pp0, app0, parts0 = st.update_p_apply_plain(op, u, p, beta, halo)
        assert torch.equal(pp, pp0)
        _close(app, app0, dtype)
        _sum_close(parts.sum(), parts0.sum(), dtype)
    for offsets in ((1, 1, 1, 1), (1, 3, 5, 7)):
        x1, r1, pv, av = (_at(n, o, gen, cuda_device, dtype) for o in offsets)
        x2, r2 = x1.clone(), r1.clone()
        _, _, parts = fc.update_x_r(x1, r1, pv, av, beta)
        _, _, parts0 = fc.update_x_r_plain(x2, r2, pv, av, beta)
        assert torch.equal(x1, x2) and torch.equal(r1, r2)
        _sum_close(parts.sum(), parts0.sum(), dtype)
    torch.cuda.synchronize()


# ----------------------- K4s: the stencil CG update that recomputes Ap' from p'


def _rnd(gen, device, dtype, *shape):
    return torch.randn(shape, generator=gen, device=device, dtype=torch.float64).to(dtype)


def _scalars(dtype, device):
    sdt = torch.float64 if dtype == torch.float64 else torch.float32
    return torch.tensor([0.37], device=device, dtype=sdt), torch.tensor([0.29], device=device, dtype=sdt)


def _k3_k4s(op, x, r, p, beta, alpha):
    """K3 without Ap' and K4s on copies of x and r: (p', x', r', K3's
    partials, K4s's partials)."""
    pp, ap, part3 = st.update_p_apply(op, r, p, beta, store_ap=False)
    assert ap is None
    xs, rs = x.clone(), r.clone()
    _, _, part4 = st.update_x_r_stencil(op, xs, rs, pp, alpha)
    return pp, xs, rs, part3, part4


def _k3_k4(op, x, r, p, beta, alpha):
    """The same iteration as K3 with Ap' and K4 (the K3 + K4 sequence)."""
    pp, ap, part3 = st.update_p_apply(op, r, p, beta)
    xs, rs = x.clone(), r.clone()
    _, _, part4 = fc.update_x_r(xs, rs, pp, ap, alpha)
    return pp, xs, rs, part3, part4


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32, torch.bfloat16])
@pytest.mark.parametrize("stencil", [27, 7])
@pytest.mark.parametrize("edge", EDGES)
def test_k4s_matches_plain_and_k3_k4_at_tile_edges(cuda_device, edge, stencil, dtype):
    """K3 without Ap' and K4s on grids at the stencil tile's edges, against
    K3 with Ap' and K4: p', x', r' and K3's partials bit for bit (K4s forms
    A p' as K3 forms Ap', FMA contraction included), the new r.r's sums
    within _sum_close (K4 and K4s group the partials differently); against
    their plain versions: p' and x' bit for bit, r' within _close (A p' as
    Ap' is), the partials' sums within _sum_close; as many partials as K3;
    a repeat gives the same bits."""
    nx, ny, nz = _edge_shape(edge, dtype)
    op = StencilOperator(nx, ny, nz, Stencil(stencil), dtype)
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    x, r, p = (_rnd(gen, cuda_device, dtype, nz, ny, nx) for _ in range(3))
    beta, alpha = _scalars(dtype, cuda_device)
    before = (st.update_x_r_stencil.launches, st.update_x_r_stencil.launches_bf16)
    got = _k3_k4s(op, x, r, p, beta, alpha)
    assert all(torch.equal(a, b) for a, b in zip(got, _k3_k4s(op, x, r, p, beta, alpha)))
    assert (st.update_x_r_stencil.launches - before[0], st.update_x_r_stencil.launches_bf16 - before[1]) == \
        (2, 2 if dtype == torch.bfloat16 else 0)
    pp, xs, rs, part3, part4 = got
    assert part4.shape == (st.num_partials(op, cuda_device),)
    want = _k3_k4(op, x, r, p, beta, alpha)
    assert all(torch.equal(a, b) for a, b in zip(got[:4], want[:4]))
    _sum_close(part4.sum(), want[4].sum(), dtype)
    xp, rp = x.clone(), r.clone()
    _, _, part_p = st.update_x_r_stencil_plain(op, xp, rp, pp, alpha)
    assert torch.equal(xs, xp)
    _close(rs, rp, dtype)
    _sum_close(part4.sum(), part_p.sum(), dtype)
    _sum_close(part3.sum(), st.update_p_apply_plain(op, r, p, beta, store_ap=False)[2].sum(), dtype)
    torch.cuda.synchronize()


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32, torch.bfloat16])
def test_k4s_on_unaligned_views_and_inactive(cuda_device, dtype):
    """K4s on x, r and p' that are views at odd element offsets (narrower
    accesses; x and r loaded in the emit) against K3 with Ap' and K4 there,
    bit for bit; with ``active`` = 0 K4s and K3 without Ap' write
    nothing."""
    nx, ny, nz = 100, 9, 7
    n = nx * ny * nz
    op = StencilOperator(nx, ny, nz, Stencil.S27, dtype)
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    x, r, p = (_at(n, off, gen, cuda_device, dtype).view(nz, ny, nx) for off in (1, 3, 5))
    beta, alpha = _scalars(dtype, cuda_device)
    want = _k3_k4(op, x, r, p, beta, alpha)
    pp = _at(n, 7, gen, cuda_device, dtype).view(nz, ny, nx)
    _, _, part3 = st.update_p_apply(op, r, p, beta, out_p=pp, store_ap=False)
    xs, rs = (_at(n, 1, gen, cuda_device, dtype).view(nz, ny, nx).copy_(v) for v in (x, r))
    _, _, part4 = st.update_x_r_stencil(op, xs, rs, pp, alpha)
    assert all(torch.equal(a, b) for a, b in zip((pp, xs, rs, part3), want[:4]))
    _sum_close(part4.sum(), want[4].sum(), dtype)
    off = torch.zeros((1,), dtype=torch.int32, device=cuda_device)
    parts = torch.full_like(part4, 5.0)
    xs, rs, out = x.clone(), r.clone(), torch.full_like(x, 7.0)
    st.update_x_r_stencil(op, xs, rs, p, alpha, partials=parts, active=off)
    st.update_p_apply(op, r, p, beta, out_p=out, partials=parts, active=off, store_ap=False)
    assert torch.equal(xs, x) and torch.equal(rs, r) and bool((out == 7.0).all()) and bool((parts == 5.0).all())
    torch.cuda.synchronize()


FUSED_SHAPES = [(64, 64, 64), (101, 37, 45)]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dims", FUSED_SHAPES)
def test_fused_solve_steps_match_k3_k4_bit_for_bit(cuda_device, dims, dtype):
    """The iterations of a single-device pallas_fused solve (K3 without Ap',
    finalize, K4s, finalize), each held against K3 with Ap' and K4 from the
    same state and scalars: p', x, r and K3's partials bit for bit at every
    iteration of 40; the recurrence then differs from the K3 + K4 sequence
    only in the order in which r.r's partials are summed."""
    prob = generate_problem(ProblemConfig(*dims, dtype=dtype), cuda_device)
    op, g = prob.A, prob.A.grid
    sdt = torch.float64 if dtype == torch.float64 else torch.float32
    sc = fc.CGScalars.new(sdt, 41, 0.0, cuda_device)
    x, p = g(prob.x0.clone()), g(prob.x0.clone())
    r = g(prob.b - st.spmv_stencil(op, g(prob.x0)).reshape(-1))
    fc.cg_finalize(torch.dot(r.reshape(-1).to(sdt), r.reshape(-1).to(sdt)).reshape(1), sc, fc.STEP_INIT)
    for _ in range(40):
        pp, ap, part3 = st.update_p_apply(op, r, p, sc.beta, store_ap=False)
        pk, apk, part3k = st.update_p_apply(op, r, p, sc.beta)
        assert ap is None and torch.equal(pp, pk) and torch.equal(part3, part3k)
        fc.cg_finalize(part3, sc, fc.STEP_PAP)
        xk, rk = x.clone(), r.clone()
        fc.update_x_r(xk, rk, pk, apk, sc.alpha)
        _, _, part4 = st.update_x_r_stencil(op, x, r, pp, sc.alpha)
        assert torch.equal(x, xk) and torch.equal(r, rk)
        fc.cg_finalize(part4, sc, fc.STEP_RR)
        p = pp
    assert int(sc.ic[fc.IC_K]) == 41


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dims", FUSED_SHAPES)
def test_fused_solve_launches_k4s_and_matches_the_k4_route(cuda_device, dims, dtype):
    """make_cg(backend="pallas_fused") on one device launches K3 and K4s
    once an iteration and K4 never; against ``cg_solve_fused`` on the K3 +
    K4 route (``halo4`` given): niters equal, the trace within WS_TRACE and
    x within WS_X_RTOL (bf16: the trace only). They are not bit-identical:
    K4 and K4s add the new r.r's partials in another order. Every K3
    launch of the first is counted in ``launches_noap`` too, none of the
    second."""
    from hpccg_tpu_torch.solver import cg_solve_fused

    prob = generate_problem(ProblemConfig(*dims, dtype=dtype), cuda_device)
    n = 40 if dtype == torch.bfloat16 else 150
    counters = [(st.update_p_apply, "launches"), (st.update_x_r_stencil, "launches"), (fc.update_x_r, "launches"),
                (st.update_p_apply, "launches_noap"), (st.update_p_apply, "launches_noap_bf16")]
    bf = n - 1 if dtype == torch.bfloat16 else 0
    before = [getattr(w, a) for w, a in counters]
    res = make_cg(prob.A, max_iter=n, tolerance=0.0, backend="pallas_fused")(prob.b, prob.x0)
    torch.cuda.synchronize()
    assert [getattr(w, a) - b for (w, a), b in zip(counters, before)] == [n - 1, n - 1, 0, n - 1, bf]
    before = [getattr(w, a) for w, a in counters]
    want = cg_solve_fused(prob.A, prob.b, prob.x0, max_iter=n, halo4=lambda rs, ps: [None])
    assert [getattr(w, a) - b for (w, a), b in zip(counters, before)] == [n - 1, 0, n - 1, 0, 0]
    assert int(res.niters) == int(want.niters) == n - 1
    rtol, floor = WS_TRACE[dtype]
    head = want.trace > floor * want.trace[0]
    torch.testing.assert_close(res.trace[head], want.trace[head], rtol=rtol, atol=0)
    if dtype != torch.bfloat16:
        _x_close(res.x, want.x)


def test_distributed_fused_solve_keeps_k4(cuda_device):
    """The distributed pallas_fused solve (halo planes from the exchange)
    keeps K3 with Ap' and K4 on every rank: two ranks of one card, 19
    iterations, 38 launches of each and none of K4s or of K3 without its
    Ap' store."""
    cfg, prob = _sharded(cuda_device, 2, (16, 12, 8), torch.float64)
    mesh = make_mesh(2, devices=[cuda_device] * 2)
    counters = [(st.update_p_apply, "launches"), (fc.update_x_r, "launches"), (st.update_x_r_stencil, "launches"),
                (st.update_p_apply, "launches_noap")]
    before = [getattr(w, a) for w, a in counters]
    res = make_distributed_cg(cfg, mesh, max_iter=20, backend="pallas_fused")(prob.b, prob.x0)
    assert int(res.niters) == 19
    assert [getattr(w, a) - b for (w, a), b in zip(counters, before)] == [38, 38, 0, 0]


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
