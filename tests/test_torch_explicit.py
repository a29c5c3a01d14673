"""The port's explicit matrices against the JAX package's: generate_ell,
the EllMatrix / DiaMatrix conversions and their plain matvecs, on the CPU.

The same numpy inputs go through both packages. generate_ell's arrays and
every conversion (to_coo, to_dia, to_ell, nnz_per_row, to_dense) must agree
exactly: they move values without arithmetic, and to_dia's duplicates add
up in the same order. The plain matvecs sum in other orders than XLA's:
max|port - jax| / max|jax| within 1e-5 in float32 and 1e-13 in float64.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import hpccg_tpu  # noqa: E402
import hpccg_tpu.models.stencil as jstencil  # noqa: E402
import hpccg_tpu.operators as jops  # noqa: E402
import hpccg_tpu_torch  # noqa: E402
from hpccg_tpu_torch.convert import dia_from_numpy, dia_to_numpy, ell_from_numpy, ell_to_numpy  # noqa: E402
from hpccg_tpu_torch.models.stencil import generate_ell  # noqa: E402

RTOL = {"float32": 1e-5, "float64": 1e-13}
# non-cubic grids, grids one cell thick, 27- and 7-point
CASES = [(9, 5, 7, 27), (9, 5, 7, 7), (6, 1, 4, 27), (1, 1, 1, 27), (5, 3, 1, 7), (1, 4, 3, 27)]


def _both(dims, dtype="float64", rank=0, size=1):
    nx, ny, nz, st = dims
    jprob = jstencil.generate_ell(hpccg_tpu.ProblemConfig(nx, ny, nz, stencil=st, dtype=getattr(jnp, dtype)),
                                  rank, size)
    prob = generate_ell(hpccg_tpu_torch.ProblemConfig(nx, ny, nz, stencil=st, dtype=getattr(torch, dtype)),
                        "cpu", rank, size)
    return jprob, prob


def _same(got, want, what=""):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want, err_msg=what)


def _wide_scatter(n, per_row, bw, seed, dtype=np.float64):
    """A random wide-band ELL with invalid slots (numpy arrays)."""
    rng = np.random.default_rng(seed)
    cols = np.clip(np.arange(n)[:, None] + rng.integers(-bw, bw + 1, (n, per_row)), 0, n - 1)
    cols[:, 0] = np.arange(n)
    vals = rng.uniform(-1.0, -0.1, (n, per_row))
    vals[:, 0] = per_row + 1.0
    valid = np.ones((n, per_row), bool)
    valid[rng.random((n, per_row)) < 0.15] = False
    valid[:, 0] = True
    return np.where(valid, vals, 0.0).astype(dtype), np.where(valid, cols, 0).astype(np.int32), valid


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("dims", CASES)
def test_generate_ell_matches_jax(dims, dtype):
    jprob, prob = _both(dims, dtype)
    for name in ("vals", "cols", "valid"):
        _same(getattr(prob.A, name), getattr(jprob.A, name), name)
    for name in ("b", "x0", "xexact"):
        _same(getattr(prob, name), getattr(jprob, name), name)
    assert (prob.A.start_row, prob.A.total_nrow) == (jprob.A.start_row, jprob.A.total_nrow)
    assert (prob.total_nrow, prob.total_nnz_model, prob.total_nnz_exact) == (
        jprob.total_nrow, jprob.total_nnz_model, jprob.total_nnz_exact)
    assert prob.A.nnz == jprob.A.nnz


@pytest.mark.parametrize("rank", [0, 1, 2])
@pytest.mark.parametrize("stencil", [27, 7])
def test_generate_ell_shards_match_jax(rank, stencil):
    """Rank r of 3 on the z-stacked domain: global columns, start_row, the
    z clipping at the global ends only, and the exact global nnz."""
    jprob, prob = _both((5, 4, 3, stencil), rank=rank, size=3)
    for name in ("vals", "cols", "valid"):
        _same(getattr(prob.A, name), getattr(jprob.A, name), name)
    _same(prob.b, jprob.b, "b")
    assert (prob.A.start_row, prob.A.total_nrow) == (jprob.A.start_row, jprob.A.total_nrow) == (60 * rank, 180)
    assert prob.total_nnz_exact == jprob.total_nnz_exact
    _same(prob.A.local_cols(), jprob.A.local_cols(), "local_cols")


def _check_conversions(A, jA):
    for got, want in zip(A.to_coo(), jA.to_coo()):
        _same(got, want, "ell to_coo")
    _same(A.nnz_per_row(), jA.nnz_per_row(), "ell nnz_per_row")
    _same(A.to_dense(), jA.to_dense(), "ell to_dense")
    D, jD = A.to_dia(max_diags=4096), jA.to_dia(max_diags=4096)
    assert D.offsets == jD.offsets and D.total_nrow == jD.total_nrow
    _same(D.data, jD.data, "to_dia data")
    for got, want in zip(D.to_coo(), jD.to_coo()):
        _same(got, want, "dia to_coo")
    _same(D.nnz_per_row(), jD.nnz_per_row(), "dia nnz_per_row")
    _same(D.to_dense(), jD.to_dense(), "dia to_dense")
    assert D.nnz == jD.nnz
    E, jE = D.to_ell(), jD.to_ell()
    for name in ("vals", "cols", "valid"):
        _same(getattr(E, name), getattr(jE, name), f"to_ell {name}")
    assert (E.start_row, E.total_nrow) == (jE.start_row, jE.total_nrow)


@pytest.mark.parametrize("dims", CASES)
def test_conversions_match_jax(dims):
    jprob, prob = _both(dims)
    _check_conversions(prob.A, jprob.A)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_conversions_match_jax_on_a_scattered_matrix(dtype):
    """A random band (two dozen offsets, invalid slots): to_dia's
    searchsorted lookup gives the JAX package's diagonal indices."""
    vals, cols, valid = _wide_scatter(400, 7, 12, seed=3, dtype=dtype)
    jA = jops.EllMatrix(vals=jnp.asarray(vals), cols=jnp.asarray(cols), valid=jnp.asarray(valid),
                        start_row=0, total_nrow=400)
    A = ell_from_numpy(vals, cols, valid, 0, 400, device="cpu")
    assert A.to_dia(max_diags=4096).ndiag == 25
    _check_conversions(A, jA)


def test_to_dia_sums_duplicate_entries_like_jax():
    vals = np.array([[4.0, 1.0, 2.0], [4.0, 0.5, 0.0], [3.0, 0.0, 0.0]])
    cols = np.array([[0, 1, 1], [1, 0, 0], [2, 0, 0]], np.int32)
    valid = np.array([[True, True, True], [True, True, False], [True, False, False]])
    jA = jops.EllMatrix(vals=jnp.asarray(vals), cols=jnp.asarray(cols), valid=jnp.asarray(valid),
                        start_row=0, total_nrow=3)
    A = ell_from_numpy(vals, cols, valid, 0, 3, device="cpu")
    D, jD = A.to_dia(), jA.to_dia()
    assert D.offsets == jD.offsets == (-1, 0, 1)
    _same(D.data, jD.data, "data")
    assert float(D.data[2, 0]) == 3.0  # 1 + 2 on (0, 1)


def test_to_dia_none_cases_match_jax():
    """None for a row shard, for a rank-0 shard of a larger matrix, for a
    matrix that stores an explicit zero, and past max_diags."""
    for rank, size in ((1, 2), (0, 2)):
        jprob, prob = _both((4, 3, 2, 27), rank=rank, size=size)
        assert prob.A.to_dia() is None and jprob.A.to_dia() is None
    jprob, prob = _both((4, 3, 2, 27))
    assert prob.A.to_dia(max_diags=5) is None and jprob.A.to_dia(max_diags=5) is None
    assert prob.A.to_dia(max_diags=27) is not None and jprob.A.to_dia(max_diags=27) is not None
    vals = np.asarray(jprob.A.vals).copy()
    vals[3, 13] = 0.0  # a stored zero on the diagonal slot, which is always valid
    assert np.asarray(jprob.A.valid)[3, 13]
    zeros = ell_from_numpy(vals, np.asarray(jprob.A.cols), np.asarray(jprob.A.valid), 0, 24, device="cpu")
    jzeros = jops.EllMatrix(vals=jnp.asarray(vals), cols=jprob.A.cols, valid=jprob.A.valid, start_row=0,
                            total_nrow=24)
    assert zeros.to_dia() is None and jzeros.to_dia() is None


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_plain_matvecs_match_jax(dtype):
    ndt = np.dtype(dtype)
    rng = np.random.default_rng(5)
    jprob, prob = _both((9, 5, 7, 27), dtype)
    vals, cols, valid = _wide_scatter(500, 9, 15, seed=6, dtype=ndt)
    scattered = (ell_from_numpy(vals, cols, valid, 0, 500, device="cpu"),
                 jops.EllMatrix(vals=jnp.asarray(vals), cols=jnp.asarray(cols), valid=jnp.asarray(valid),
                                start_row=0, total_nrow=500))
    for A, jA in ((prob.A, jprob.A), scattered):
        x = rng.standard_normal(A.local_nrow).astype(ndt)
        D, jD = A.to_dia(max_diags=4096), jA.to_dia(max_diags=4096)
        for op, jop in ((A, jA), (D, jD)):
            got = op.matvec(torch.from_numpy(x)).numpy()
            want = np.asarray(jop.matvec(jnp.asarray(x)))
            assert got.dtype == want.dtype == ndt
            assert np.max(np.abs(got - want)) <= RTOL[dtype] * np.max(np.abs(want)), type(op).__name__


def test_dia_round_trips_through_numpy():
    jprob, prob = _both((6, 5, 4, 7))
    jD = jprob.A.to_dia()
    D = dia_from_numpy(np.asarray(jD.data), jD.offsets, jD.total_nrow, device="cpu")
    assert D.offsets == prob.A.to_dia().offsets
    _same(D.data, prob.A.to_dia().data)
    back = dia_to_numpy(D)
    assert back["offsets"] == tuple(jD.offsets) and back["total_nrow"] == jD.total_nrow
    _same(back["data"], jD.data)


def test_ell_round_trips_through_numpy():
    """A rank's shard keeps its partition metadata both ways."""
    jprob, _ = _both((6, 5, 4, 27), rank=1, size=3)
    jA = jprob.A
    A = ell_from_numpy(jA.vals, jA.cols, jA.valid, jA.start_row, jA.total_nrow, device="cpu")
    back = ell_to_numpy(A)
    assert (back["start_row"], back["total_nrow"]) == (jA.start_row, jA.total_nrow) == (120, 360)
    for name in ("vals", "cols", "valid"):
        _same(back[name], getattr(jA, name), name)
