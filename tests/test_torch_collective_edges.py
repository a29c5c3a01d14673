"""The collective whole solves K15 (cg, cg1) and K16 (pipecg) against their
plain versions on grids at the edges of the staged tile they march, on the
card.

The CUDA kernel (``csrc/collective.cu``) marches K5's staged tile over each
rank's slab: 16 bytes of a row a thread (V = 4 points in float32, 2 in
float64, 8 in bfloat16), a tile 32 V wide and TY rows high, work items of a
z chunk that the geometry picks per launch (``collective.geometry``: it
depends on the grid and on the rank count), and elementwise passes on the
same rows, 16 bytes at a time where the row allows it. Here every method
runs on per-rank grids across those edges: nx below V, nx = 100, nx one
below and one above the tile width, ny not a multiple of TY, nz one below
and one above the chosen z chunk; at 1, 2, 4 and 8 ranks of one card; in
float32, float64 and bfloat16, 27- and 7-point. Then on b and x0 shards that
are views at odd element offsets (the init stages and reads them on
narrower accesses; the loop keeps 16 bytes), and on a grid whose work
items outnumber a rank's blocks.

Limits as in ``tests/test_torch_cuda.py::test_collective_matches_plain``
and ``::test_bf16_collective_matches_plain``: 30 iterations, stopped by a
tolerance between the two plain trace entries that straddle the floor;
niters equal, the trace within WS_TRACE (pipecg: PIPE_TRACE), x within
WS_X_RTOL (pipecg: PIPE_X_RTOL; bf16: at most 4 ulps apart in at most 1e-3
of the elements), two launches bit-identical. bf16 pipecg is held whole on
solves of PIPE_BF16_HEAD iterations and over its first PIPE_BF16_HEAD
trace entries on the 30.

Every test is marked ``cuda`` and skips without an NVIDIA GPU. Like
``test_torch_cuda.py`` the file imports torch only, so the machine with the
card runs it without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_collective_edges.py
"""

import functools

import pytest

torch = pytest.importorskip("torch")

from hpccg_tpu_torch import ProblemConfig  # noqa: E402
from hpccg_tpu_torch.config import Stencil  # noqa: E402
from hpccg_tpu_torch.operators import StencilOperator  # noqa: E402
from hpccg_tpu_torch.ops.cuda import collective as col  # noqa: E402
from hpccg_tpu_torch.parallel import generate_problem_sharded, make_mesh  # noqa: E402

from test_torch_cuda import (  # noqa: E402,F401
    BF16,
    PIPE_BF16_HEAD,
    PIPE_TRACE,
    PIPE_X_RTOL,
    WS_TRACE,
    _at,
    _x_close,
    cuda_device,
)

pytestmark = pytest.mark.cuda

EDGES = ["nx<V", "nx=100", "nx=TX-1", "nx=TX+1", "ny%TY", "nz=ZC-1", "nz=ZC+1"]
DTYPES = [torch.float32, torch.float64, torch.bfloat16]
NDEVS = [1, 2, 4, 8]
METHODS = ["cg", "cg1", "pipecg"]
# per rank: 50 tiles of 32 V x 8 points, more than a rank's blocks at 8 ranks in every dtype
MULTI = (64, 400, 9)


def _geometry(dims, ndev, dtype, stencil):
    return col.geometry(StencilOperator(*dims, Stencil(stencil), dtype), ndev, dtype, "cg")


def _edge_shape(edge, ndev, dtype, stencil):
    """A rank's (nx, ny, nz) at ``edge`` of the kernel's geometry for
    ``dtype`` at ``ndev`` ranks. The z chunk is chosen per grid, so the z
    edges are grids whose chosen chunk is one above or one below their nz,
    the largest chunk for which the search finds one."""
    g = _geometry((64, 64, 64), ndev, dtype, stencil)
    tx, ty = g.tile_x, g.tile_y
    shapes = {"nx<V": (max(tx // 32 - 1, 1), ty + 3, 5), "nx=100": (100, ty + 3, 7), "nx=TX-1": (tx - 1, ty + 1, 6),
              "nx=TX+1": (tx + 1, 2 * ty + 1, 5), "ny%TY": (33, 3 * ty + 5, 9)}
    if edge in shapes:
        return shapes[edge]
    zc = _geometry((tx * 8, ty * 128, 4096), ndev, dtype, stencil).z_chunk
    while zc >= 2:
        nz = zc - 1 if edge == "nz=ZC-1" else zc + 1
        for ky in range(1, 4096):
            if _geometry((tx + 1, ty * ky + 1, nz), ndev, dtype, stencil).z_chunk == zc:
                return tx + 1, ty * ky + 1, nz
        zc //= 2
    raise AssertionError(f"no grid at {edge}")


def _kernel(method):
    return col.cg_collective_pipelined if method == "pipecg" else functools.partial(col.cg_collective, method=method)


def _held(op, bs, x0s, method):
    """One method's kernel against its plain version on (bs, x0s), as the
    module docstring says."""
    dtype = bs[0].dtype
    rtol, floor = (PIPE_TRACE if method == "pipecg" and dtype != BF16 else WS_TRACE)[dtype]
    chaotic = method == "pipecg" and dtype == BF16
    for iters in (PIPE_BF16_HEAD, 30) if chaotic else (30,):
        tr = col.solve_plain(op, bs, x0s, method=method, max_iter=iters).trace
        below = torch.nonzero(tr < floor * tr[0])
        tol = 0.0 if below.numel() == 0 else float(torch.sqrt(tr[int(below[0]) - 1] * tr[int(below[0])]))
        want = col.solve_plain(op, bs, x0s, method=method, max_iter=iters, tolerance=tol)
        got, again = (_kernel(method)(op, bs, x0s, max_iter=iters, tolerance=tol) for _ in range(2))
        torch.cuda.synchronize()
        n = int(want.niters) + 1
        assert int(got.niters) == n - 1, (method, iters)
        whole = not chaotic or iters <= PIPE_BF16_HEAD
        m = n if whole else min(n, PIPE_BF16_HEAD)
        torch.testing.assert_close(got.trace[:m], want.trace[:m], rtol=rtol, atol=0)
        assert bool(torch.isnan(got.trace[n:]).all())
        gx, wx = torch.cat(got.x), torch.cat(want.x)
        if whole:
            # a flush of both r.r and r.u (f32 cg1) turns x to NaN on both sides: the recurrence's 0/0
            nan = torch.isnan(wx)
            assert torch.equal(torch.isnan(gx), nan)
            if not bool(nan.all()):
                _x_close(gx[~nan], wx[~nan], PIPE_X_RTOL.get(dtype) if method == "pipecg" else None)
        else:
            assert bool(torch.isfinite(gx.float()).all())
        assert all(torch.equal(a, b) for a, b in zip(got.x, again.x)) and torch.equal(got.trace[:n], again.trace[:n])


def _sharded(device, ndev, dims, dtype, stencil):
    cfg = ProblemConfig(*dims, stencil=stencil, dtype=dtype)
    prob = generate_problem_sharded(cfg, make_mesh(ndev, devices=[device] * ndev))
    return StencilOperator(*dims, Stencil(stencil), dtype), prob


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64", "bf16"])
@pytest.mark.parametrize("ndev", NDEVS)
@pytest.mark.parametrize("edge", EDGES)
def test_collective_at_tile_edges(cuda_device, edge, ndev, dtype):
    """K15 and K16 against their plain versions on a rank grid at ``edge``
    (_edge_shape), 27-point on the even edges of EDGES and 7-point on the
    odd ones."""
    stencil = 27 if EDGES.index(edge) % 2 == 0 else 7
    dims = _edge_shape(edge, ndev, dtype, stencil)
    op, prob = _sharded(cuda_device, ndev, dims, dtype, stencil)
    for method in METHODS:
        _held(op, prob.b, prob.x0, method)


@pytest.mark.parametrize("ndev", [2, 4])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64", "bf16"])
def test_collective_on_unaligned_views(cuda_device, dtype, ndev):
    """b and x0 shards that are views at element offsets 1 and 3: the init
    reads them (and the peers' x0 planes) on accesses narrower than 16
    bytes, the loop keeps 16 (launch.access); the same bits as on aligned
    copies of the same values, and the plain version's result as above."""
    op, prob = _sharded(cuda_device, ndev, (128, 9, 7), dtype, 27)
    n = op.local_nrow
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    bs = tuple(_at(n, 1, gen, cuda_device, dtype).copy_(b) for b in prob.b)
    x0s = tuple(_at(n, 3, gen, cuda_device, dtype) for _ in prob.x0)
    assert all(v.data_ptr() % 16 != 0 for v in bs + x0s)
    for method in METHODS:
        got = _kernel(method)(op, bs, x0s, max_iter=10)
        assert col.launch.access[0] == 16 and col.launch.access[1] < 16
        want = _kernel(method)(op, tuple(v.clone() for v in bs), tuple(v.clone() for v in x0s), max_iter=10)
        assert col.launch.access == (16, 16)
        assert int(got.niters) == int(want.niters) == 9
        assert all(torch.equal(a, b) for a, b in zip(got.x, want.x)) and torch.equal(got.trace, want.trace)
        _held(op, bs, tuple(_at(n, 3, gen, cuda_device, dtype).copy_(x) for x in prob.x0), method)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64", "bf16"])
def test_collective_with_more_items_than_blocks(cuda_device, dtype):
    """8 ranks of MULTI: a rank's blocks take several work items each."""
    op, prob = _sharded(cuda_device, 8, MULTI, dtype, 27)
    for method in METHODS:
        g = col.geometry(op, 8, dtype, method)
        assert g.items > g.blocks_per_rank
        _held(op, prob.b, prob.x0, method)
