"""The plain version of K17, the collective whole solve of a banded (DIA)
matrix (methods cg and cg1), against the JAX package, on the CPU.

At 2 ranks the reference is JAX's collective DIA kernel itself, run as
tests/test_collective_dia.py runs it (interpret mode, in-kernel remote
copies between the virtual devices), through ``make_collective_dia_cg``:
n = 512 with a scattered band of +-150 (multi-row strips), float32, 12
iterations. Each such call takes 10-12 s here, so there are two. The limits
are JAX's for that kernel: niters equal, trace rtol 2e-4 above 1e-6 *
trace[0], x within 1e-3 of xexact.

At 4, 6 and 8 ranks the reference is JAX's distributed DIA solve
(``make_distributed_dia_cg``) with the same method in float64, at the
limits of its distributed file mode: niters equal, trace rtol 1e-9 above
1e-12 * trace[0], x rtol 1e-9 (atol 1e-12). K17 sums the ranks' partials in
rank order where JAX's kernel uses recursive doubling at 4 and 8 ranks, so
traces part in the last bits and are held to a tolerance.

K17's grid (``ops.cuda.collective.dia_grid``) is held at the edges of its
tile of 256 threads x 4 rows, and the plain version against
JAX's distributed DIA solve on shards one row below, at and above the tile
and on b/x0 views at odd element offsets (the shapes chip_smoke.py runs
the kernel at).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from hpccg_tpu.operators import DiaMatrix as JDia  # noqa: E402
from hpccg_tpu.parallel import make_collective_dia_cg as jmake_collective_dia  # noqa: E402
from hpccg_tpu.parallel import make_distributed_dia_cg as jmake_dia  # noqa: E402
from hpccg_tpu.parallel import make_mesh as jmake_mesh  # noqa: E402
from hpccg_tpu_torch.convert import explicit_problem_from_numpy, shards_to_numpy  # noqa: E402
from hpccg_tpu_torch.operators import DiaMatrix  # noqa: E402
from hpccg_tpu_torch.ops.cuda import collective as col  # noqa: E402
from hpccg_tpu_torch.parallel import make_collective_dia_cg, make_distributed_dia_cg, make_mesh  # noqa: E402
from hpccg_tpu_torch.parallel.cg import collective_dia_supported  # noqa: E402


def _band_data(n, offsets, seed, dtype):
    rng = np.random.default_rng(seed)
    data = np.zeros((len(offsets), n), dtype)
    for d, off in enumerate(offsets):
        lo, hi = max(0, -off), min(n, n - off)
        data[d, lo:hi] = 2.0 * len(offsets) if off == 0 else rng.uniform(-1, -0.1, hi - lo)
    return data


def _scattered(n, span=150, ndiag_draw=12, seed=0, dtype=np.float32):
    """The scattered band of tests/test_collective_dia.py:_banded."""
    rng = np.random.default_rng(seed)
    offs = sorted(set([0] + [int(o) for o in rng.integers(-span, span + 1, ndiag_draw)]))
    data = np.zeros((len(offs), n), dtype)
    for d, off in enumerate(offs):
        lo, hi = max(0, -off), min(n, n - off)
        data[d, lo:hi] = 2.0 * len(offs) if off == 0 else rng.uniform(-1, -0.1, hi - lo)
    return data, tuple(offs)


def _both(data, offsets, ndev):
    """The JAX DiaMatrix with b = A 1, x0 = 0, and the port's problem sharded
    over ndev CPU ranks."""
    n = data.shape[1]
    A = JDia(data=jnp.asarray(data), offsets=offsets, total_nrow=n)
    xex = jnp.ones((n,), A.dtype)
    b = A.matvec(xex)
    prob = explicit_problem_from_numpy({"data": data, "offsets": offsets, "total_nrow": n}, np.asarray(b),
                                       np.zeros(n, data.dtype), np.ones(n, data.dtype), device="cpu",
                                       mesh=make_mesh(ndev, devices=["cpu"] * ndev))
    return (A, b, jnp.zeros_like(b)), prob


def _k17(prob, method, max_iter, tolerance=0.0):
    before = col.cg_collective_dia.launches
    res = col.cg_collective_dia(prob.A, prob.b, prob.x0, method=method, max_iter=max_iter, tolerance=tolerance)
    assert col.cg_collective_dia.launches == before  # plain on the CPU: no launch
    return res


@pytest.mark.parametrize("method", ["cg", "cg1"])
def test_plain_matches_jax_collective_dia_kernel(method):
    data, offs = _scattered(512)
    (A, b, x0), prob = _both(data, offs, 2)
    assert max(-offs[0], offs[-1]) > 128  # the strips are more than one 128-lane row
    jres = jmake_collective_dia(jmake_mesh(2), max_iter=12, method=method)(A, b, x0)
    res = _k17(prob, method, 12)
    assert int(res.niters) == int(jres.niters) == 11
    jt = np.asarray(jres.trace)
    good = np.isfinite(jt) & (jt > 1e-6 * jt[0])
    np.testing.assert_allclose(res.trace.numpy()[good], jt[good], rtol=2e-4)
    assert np.abs(shards_to_numpy(res.x) - 1.0).max() < 1e-3


@pytest.mark.parametrize("method", ["cg", "cg1"])
@pytest.mark.parametrize("ndev", [4, 6, 8])
def test_plain_matches_jax_distributed_dia(ndev, method):
    data = _band_data(240, (-13, -5, -1, 0, 1, 5, 13), 0, np.float64)
    (A, b, x0), prob = _both(data, (-13, -5, -1, 0, 1, 5, 13), ndev)
    jres = jmake_dia(jmake_mesh(ndev), max_iter=30, method=method)(A, b, x0)
    res = _k17(prob, method, 30)
    assert int(res.niters) == int(jres.niters) == 29
    jt = np.asarray(jres.trace)
    head = jt > 1e-12 * jt[0]
    assert head[:10].all()
    np.testing.assert_allclose(res.trace.numpy()[head], jt[head], rtol=1e-9)
    np.testing.assert_allclose(shards_to_numpy(res.x), np.asarray(jres.x), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(float(res.normr) ** 2, float(res.rtrans), rtol=1e-12)


@pytest.mark.parametrize("method", ["cg", "cg1"])
def test_band_as_wide_as_the_shard(method):
    """bw_lo = bw_hi = L = 30 on 8 ranks: every row of a rank goes to both
    neighbours' strips. Against JAX's distributed DIA solve, f64."""
    data = _band_data(240, (-30, -7, 0, 7, 30), 3, np.float64)
    (A, b, x0), prob = _both(data, (-30, -7, 0, 7, 30), 8)
    assert prob.A[0].local_nrow == prob.A[0].bw_lo == prob.A[0].bw_hi == 30
    jres = jmake_dia(jmake_mesh(8), max_iter=30, method=method)(A, b, x0)
    res = _k17(prob, method, 30)
    assert int(res.niters) == int(jres.niters)
    jt = np.asarray(jres.trace)
    head = jt > 1e-12 * jt[0]
    np.testing.assert_allclose(res.trace.numpy()[head], jt[head], rtol=1e-9)
    np.testing.assert_allclose(shards_to_numpy(res.x), np.asarray(jres.x), rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("method", ["cg", "cg1"])
def test_tolerance_exit_matches_jax(method):
    """A tolerance run: cg tests the normr of its last top, cg1 gamma_top
    (one update older), as the JAX kernels do."""
    data = _band_data(240, (-13, -5, -1, 0, 1, 5, 13), 1, np.float64)
    (A, b, x0), prob = _both(data, (-13, -5, -1, 0, 1, 5, 13), 4)
    jres = jmake_dia(jmake_mesh(4), max_iter=200, tolerance=1e-9, method=method)(A, b, x0)
    res = _k17(prob, method, 200, tolerance=1e-9)
    assert int(res.niters) == int(jres.niters) < 199
    np.testing.assert_allclose(float(res.normr), float(jres.normr), rtol=1e-6)


def test_diagonal_only_band_needs_no_exchange():
    """offsets (0,): no strips at all; the elementwise system solves in one
    iteration (tests/test_collective_dia.py's diagonal-only case)."""
    diag = np.random.default_rng(1).uniform(1.0, 2.0, (1, 1024)).astype(np.float32)
    _, prob = _both(diag, (0,), 2)
    assert prob.A[0].bw_lo == prob.A[0].bw_hi == 0
    res = _k17(prob, "cg1", 10, tolerance=1e-12)
    assert float(res.normr) < 1e-3
    np.testing.assert_allclose(shards_to_numpy(res.x), 1.0, rtol=1e-5)


def test_k17_matches_the_dia_halo_tier():
    """K17's plain version and the dia-halo tier (cg) run the same sharded
    recurrence: the same bits on 4 ranks."""
    data = _band_data(240, (-13, -5, -1, 0, 1, 5, 13), 0, np.float64)
    _, prob = _both(data, (-13, -5, -1, 0, 1, 5, 13), 4)
    mesh = make_mesh(4, devices=["cpu"] * 4)
    res = make_collective_dia_cg(mesh, max_iter=30, method="cg")(prob.A, prob.b, prob.x0)
    ref = make_distributed_dia_cg(mesh, max_iter=30)(prob.A, prob.b, prob.x0)
    assert torch.equal(res.trace, ref.trace)
    assert all(torch.equal(a, b) for a, b in zip(res.x, ref.x))


def test_refusals():
    """bfloat16, rows that do not divide the ranks, a band wider than the
    shard and pipecg are refused, each with its reason."""
    data = _band_data(240, (-13, 0, 13), 0, np.float32)
    _, prob = _both(data, (-13, 0, 13), 2)
    mesh = make_mesh(2, devices=["cpu"] * 2)
    bf_blocks = tuple(type(blk)(data=blk.data.to(torch.bfloat16), offsets=blk.offsets, start_row=blk.start_row,
                                total_nrow=blk.total_nrow) for blk in prob.A)
    bf = tuple(v.to(torch.bfloat16) for v in prob.b)
    with pytest.raises(ValueError, match="bfloat16"):
        col.cg_collective_dia(bf_blocks, bf, bf, max_iter=5)
    A_bf = DiaMatrix(data=torch.from_numpy(data).to(torch.bfloat16), offsets=(-13, 0, 13))
    ok, reason = collective_dia_supported(A_bf, mesh)
    assert not ok and "float32 or float64" in reason
    solve = make_collective_dia_cg(make_mesh(7, devices=["cpu"] * 7), max_iter=5)
    A = DiaMatrix(data=torch.from_numpy(data), offsets=(-13, 0, 13), total_nrow=240)
    b = A.matvec(torch.ones(240))
    with pytest.raises(ValueError, match="pad_problem_rows"):
        solve(A, b, torch.zeros_like(b))
    wide = DiaMatrix(data=torch.from_numpy(_band_data(240, (-100, 0, 100), 0, np.float32)), offsets=(-100, 0, 100))
    with pytest.raises(ValueError, match="bandwidth"):
        make_collective_dia_cg(make_mesh(4, devices=["cpu"] * 4), max_iter=5)(wide, b, torch.zeros_like(b))
    with pytest.raises(ValueError, match="cg and cg1"):
        make_collective_dia_cg(mesh, max_iter=5, method="pipecg")
    with pytest.raises(ValueError, match="cg and cg1"):
        col.cg_collective_dia(prob.A, prob.b, prob.x0, method="pipecg", max_iter=5)
    with pytest.raises(TypeError, match="DiaRows"):
        col.cg_collective_dia(prob.b, prob.b, prob.x0, max_iter=5)


# K17's tile (csrc/collective_dia.cu): 256 threads x 4 rows
TILE_ROWS = {np.float32: 1024, np.float64: 1024}


@pytest.mark.parametrize("L, ndev, resident, tile, want", [
    (1023, 1, 396, 1024, (1, 1)), (1024, 2, 396, 1024, (1, 1)), (1025, 4, 396, 1024, (2, 2)),
    (1023, 1, 264, 1024, (1, 1)), (1025, 8, 264, 1024, (2, 2)), (524288, 4, 396, 1024, (512, 99)),
    (524288, 4, 264, 1024, (512, 66)), (524288, 4, 528, 1024, (512, 132)), (100000, 8, 396, 1024, (98, 49))])
def test_dia_grid(L, ndev, resident, tile, want):
    """K17's grid: a rank's row tiles and its blocks, one per tile, capped by
    the card's resident blocks shared by the ranks (on an H100 4 x 132 for
    float32 cg, 3 x 132 for cg1, 2 x 132 in float64). 4 x 524288 rows is the
    main path's 128^3."""
    assert col.dia_grid(L, ndev, resident, tile) == want


@pytest.mark.parametrize("extra", [-1, 0, 1])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_plain_matches_jax_at_the_tile_edges(dtype, extra):
    """Shards of one row below, at and one above K17's tile (an odd L is not
    a multiple of a 16-byte word's values), 2 ranks, a band of +-200, cg: the plain K17 against
    JAX's distributed DIA solve. float64: niters equal, trace rtol 1e-9
    above 1e-12 * trace[0], x rtol 1e-9 (this file's limits); float32 over
    12 iterations: trace rtol 1e-4 above 1e-5 * trace[0], x within 1e-5 of
    max|x| (the card's K17-against-plain limits, WS_TRACE / WS_X_RTOL in
    chip_smoke.py): the two sum the diagonals and the dots in other orders."""
    offs = (-200, -37, -1, 0, 1, 37, 200)
    L = TILE_ROWS[dtype] + extra
    iters = 30 if dtype == np.float64 else 12
    data = _band_data(2 * L, offs, 4, dtype)
    (A, b, x0), prob = _both(data, offs, 2)
    assert prob.A[0].local_nrow == L
    jres = jmake_dia(jmake_mesh(2), max_iter=iters, method="cg")(A, b, x0)
    res = _k17(prob, "cg", iters)
    assert int(res.niters) == int(jres.niters) == iters - 1
    jt = np.asarray(jres.trace)
    rtol, floor, xrtol = (1e-9, 1e-12, 1e-9) if dtype == np.float64 else (1e-4, 1e-5, 1e-5)
    head = jt > floor * jt[0]
    np.testing.assert_allclose(res.trace.numpy()[head], jt[head], rtol=rtol)
    jx = np.asarray(jres.x)
    assert np.abs(shards_to_numpy(res.x) - jx).max() <= xrtol * np.abs(jx).max()


@pytest.mark.parametrize("method", ["cg", "cg1"])
def test_plain_takes_views_at_odd_offsets(method):
    """b and x0 shards that are views at element offsets 1 and 3 (the card's
    16-byte accesses fall back to one element at a time there): the same
    bits as on contiguous shards, and JAX's distributed DIA solve, float64,
    4 ranks of 1024 rows, at this file's limits."""
    offs = (-200, -37, -1, 0, 1, 37, 200)
    data = _band_data(4096, offs, 5, np.float64)
    (A, b, x0), prob = _both(data, offs, 4)

    def view(v, k):
        return torch.empty((v.numel() + k,), dtype=v.dtype)[k:].copy_(v)

    bs, x0s = tuple(view(v, 1) for v in prob.b), tuple(view(v, 3) for v in prob.x0)
    res = col.cg_collective_dia(prob.A, bs, x0s, method=method, max_iter=30)
    ref = _k17(prob, method, 30)
    assert torch.equal(res.trace, ref.trace) and all(torch.equal(a, c) for a, c in zip(res.x, ref.x))
    jres = jmake_dia(jmake_mesh(4), max_iter=30, method=method)(A, b, x0)
    jt = np.asarray(jres.trace)
    head = jt > 1e-12 * jt[0]
    np.testing.assert_allclose(res.trace.numpy()[head], jt[head], rtol=1e-9)
    np.testing.assert_allclose(shards_to_numpy(res.x), np.asarray(jres.x), rtol=1e-9, atol=1e-12)
