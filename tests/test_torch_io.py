"""The port's HPC-row reader and writer, RCM and structure chooser against
the JAX package's, on the CPU.

Files are written from seeded numpy data; both packages read the same file.
Everything here moves values without arithmetic, so the arrays must agree
exactly. The JAX package's ``rcm_permutation`` tries its native C++ order
before scipy's; the tests that compare orders pin it to scipy's, which is
the one the port uses.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import hpccg_tpu  # noqa: E402
import hpccg_tpu.io as jio  # noqa: E402
import hpccg_tpu.operators as jops  # noqa: E402
import hpccg_tpu.reorder as jreorder  # noqa: E402
from hpccg_tpu import native  # noqa: E402
from hpccg_tpu_torch import ProblemConfig  # noqa: E402
from hpccg_tpu_torch import io as tio  # noqa: E402
from hpccg_tpu_torch.convert import ell_from_numpy  # noqa: E402
from hpccg_tpu_torch.models.stencil import generate_ell  # noqa: E402
from hpccg_tpu_torch.operators import DiaMatrix, EllMatrix  # noqa: E402
from hpccg_tpu_torch.reorder import auto_structure, permute_ell, rcm_permutation  # noqa: E402


@pytest.fixture
def scipy_rcm(monkeypatch):
    """The JAX package's RCM through scipy, as the port's."""
    monkeypatch.setattr(native, "rcm", lambda *args: None)


def _same(got, want, what=""):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want, err_msg=what)


def _stencil_problem(dims=(6, 5, 4), dtype=torch.float64):
    return generate_ell(ProblemConfig(*dims, dtype=dtype), "cpu")


def permuted_twin(prob, seed):
    """The problem with rows and columns randomly permuted (b and xexact
    with them): a wide scatter whose band RCM can recover."""
    perm = np.random.default_rng(seed).permutation(prob.total_nrow)
    index = torch.from_numpy(perm)
    return dataclasses.replace(prob, A=permute_ell(prob.A, perm), b=prob.b[index], xexact=prob.xexact[index])


def _with_stored_zero(prob):
    vals = prob.A.vals.clone()
    vals[3, 13] = 0.0  # the diagonal slot, always valid
    return dataclasses.replace(prob, A=dataclasses.replace(prob.A, vals=vals))


def _ell_arrays_equal(A, jA):
    for name in ("vals", "cols", "valid"):
        _same(getattr(A, name), getattr(jA, name), name)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("case", ["stencil", "permuted", "stored_zero"])
def test_port_writer_is_read_by_jax(tmp_path, case, dtype):
    prob = _stencil_problem(dtype=getattr(torch, dtype))
    prob = {"stencil": prob, "permuted": permuted_twin(prob, 1), "stored_zero": _with_stored_zero(prob)}[case]
    x = np.random.default_rng(2).standard_normal(prob.total_nrow).astype(dtype)
    path = str(tmp_path / "m.txt")
    tio.write_hpc_row(path, prob, x)
    jprob, jx = jio.read_hpc_row(path, dtype=getattr(jnp, dtype), to_dia=False, device=False)
    for got, want in zip(prob.A.to_coo(), jprob.A.to_coo()):  # the reader packs each row's entries
        _same(got, want)
    for got, want in ((x, jx), (prob.b, jprob.b), (prob.xexact, jprob.xexact)):
        _same(got, want)
    port, px = tio.read_hpc_row(path, dtype=getattr(torch, dtype), to_dia=False, device="cpu")
    _ell_arrays_equal(port.A, jprob.A)
    _same(px, jx)
    assert port.total_nnz_model == jprob.total_nnz_model == prob.A.nnz


def test_dia_problem_writes_like_its_ell(tmp_path):
    prob = _stencil_problem()
    tio.write_hpc_row(str(tmp_path / "ell.txt"), prob)
    tio.write_hpc_row(str(tmp_path / "dia.txt"), dataclasses.replace(prob, A=prob.A.to_dia()))
    assert (tmp_path / "ell.txt").read_text() == (tmp_path / "dia.txt").read_text()


@pytest.mark.parametrize("to_dia", [True, False])
def test_jax_writer_is_read_by_port(tmp_path, to_dia):
    jprob = hpccg_tpu.models.stencil.generate_ell(hpccg_tpu.ProblemConfig(5, 4, 3, dtype=jnp.float64))
    x = np.random.default_rng(3).standard_normal(jprob.total_nrow)
    path = str(tmp_path / "j.txt")
    jio.write_hpc_row(path, jprob, x)
    jread, jx = jio.read_hpc_row(path, dtype=jnp.float64, to_dia=to_dia)
    prob, px = tio.read_hpc_row(path, dtype=torch.float64, to_dia=to_dia, device="cpu")
    if to_dia:
        assert isinstance(prob.A, DiaMatrix) and prob.A.offsets == jread.A.offsets
        _same(prob.A.data, jread.A.data)
    else:
        assert isinstance(prob.A, EllMatrix)
        _ell_arrays_equal(prob.A, jread.A)
    for got, want in ((px, jx), (prob.b, jread.b), (prob.xexact, jread.xexact)):
        _same(got, want)


def test_structured_banded_file_is_dia(tmp_path):
    path = str(tmp_path / "band.txt")
    tio.write_hpc_row(path, _stencil_problem((7, 6, 5)))
    prob, perm, report = tio.read_hpc_row_structured(path, device="cpu")
    jprob, jperm, jreport = jio.read_hpc_row_structured(path, dtype=jnp.float64)
    assert report.format == jreport.format == "dia" and perm is None and jperm is None
    assert report.ndiag == jreport.ndiag == prob.A.ndiag == 27
    assert report.reason == jreport.reason
    _same(prob.A.data, jprob.A.data)


def test_rcm_permutation_matches_jax(scipy_rcm):
    prob = permuted_twin(_stencil_problem((8, 7, 6)), 4)
    vals, cols, valid = (getattr(prob.A, n).numpy() for n in ("vals", "cols", "valid"))
    jA = jops.EllMatrix(vals=vals, cols=cols, valid=valid, start_row=0, total_nrow=prob.total_nrow)
    perm = rcm_permutation(prob.A)
    np.testing.assert_array_equal(perm, jreorder.rcm_permutation(jA))
    B, jB = permute_ell(prob.A, perm), jreorder.permute_ell(jA, perm)
    _ell_arrays_equal(B, jB)
    assert jreorder.bandwidth(jB) < jreorder.bandwidth(jA)


def test_rcm_numpy_fallback_matches_jax(monkeypatch, scipy_rcm):
    """Without scipy both packages run their NumPy BFS: the same order, a
    permutation whose band is close to scipy's."""
    import builtins

    from hpccg_tpu_torch.reorder import bandwidth

    A = permuted_twin(_stencil_problem((6, 6, 6)), 5).A
    jA = jops.EllMatrix(vals=A.vals.numpy(), cols=A.cols.numpy(), valid=A.valid.numpy(), start_row=0,
                        total_nrow=A.local_nrow)
    with_scipy = rcm_permutation(A)
    real_import = builtins.__import__

    def no_scipy(name, *args, **kw):
        if name.startswith("scipy"):
            raise ImportError(name)
        return real_import(name, *args, **kw)

    monkeypatch.setattr(builtins, "__import__", no_scipy)
    fallback, jfallback = rcm_permutation(A), jreorder.rcm_permutation(jA)
    monkeypatch.setattr(builtins, "__import__", real_import)
    np.testing.assert_array_equal(fallback, jfallback)
    assert sorted(fallback.tolist()) == list(range(A.local_nrow))
    assert bandwidth(permute_ell(A, fallback)) <= 1.5 * bandwidth(permute_ell(A, with_scipy))


def test_permuted_stencil_file_is_ell_rcm(tmp_path, scipy_rcm):
    path = str(tmp_path / "perm.txt")
    tio.write_hpc_row(path, permuted_twin(_stencil_problem((8, 8, 8)), 6))
    prob, perm, report = tio.read_hpc_row_structured(path, device="cpu")
    assert report.format == "ell+rcm" and perm is not None
    assert report.bandwidth_after < report.bandwidth_before
    np.testing.assert_array_equal(perm, jreorder.rcm_permutation(jio.read_hpc_row(path, to_dia=False)[0].A))
    jfile, _ = jio.read_hpc_row(path, dtype=jnp.float64, to_dia=False, device=False)
    for name in ("b", "x0", "xexact"):  # the file's vectors in the solve basis
        _same(getattr(prob, name), np.asarray(getattr(jfile, name))[perm], name)


def test_stored_zeros_file_stays_ell(tmp_path):
    path = str(tmp_path / "zeros.txt")
    tio.write_hpc_row(path, _with_stored_zero(_stencil_problem()))
    prob, perm, report = tio.read_hpc_row_structured(path, device="cpu")
    _, jperm, jreport = jio.read_hpc_row_structured(path, dtype=jnp.float64)
    assert report.format == jreport.format == "ell" and perm is None and jperm is None
    assert "explicit zero entries" in report.reason and "explicit zero entries" in jreport.reason
    assert isinstance(prob.A, EllMatrix) and float(prob.A.vals[3, 13]) == 0.0


@pytest.mark.parametrize("case,dims,dtype,want", [
    ("banded", (7, 6, 5), "float64", "dia"),
    # slot inflation past 64: no DIA
    ("permuted", (10, 10, 10), "float64", "ell"),
    # ~400 diagonals at inflation ~20: DIA as loaded (the JAX package caps
    # float64 at 256 diagonals off the TPU, so float32 here)
    ("permuted", (7, 6, 5), "float32", "dia"),
])
def test_no_reorder_branch(tmp_path, case, dims, dtype, want):
    prob = _stencil_problem(dims, getattr(torch, dtype))
    path = str(tmp_path / f"{case}.txt")
    tio.write_hpc_row(path, prob if case == "banded" else permuted_twin(prob, 7))
    got, perm, report = tio.read_hpc_row_structured(path, dtype=getattr(torch, dtype), reorder=False, device="cpu")
    _, jperm, jreport = jio.read_hpc_row_structured(path, dtype=getattr(jnp, dtype), reorder=False)
    assert perm is None and jperm is None
    assert report.format == jreport.format == want
    assert "reorder" in report.reason
    assert isinstance(got.A, DiaMatrix if want == "dia" else EllMatrix)


def test_unpermute_round_trips(tmp_path):
    prob = permuted_twin(_stencil_problem((6, 6, 5)), 8)
    op, perm, report = auto_structure(prob.A)
    assert report.format == "ell+rcm"
    x = np.random.default_rng(9).standard_normal(prob.total_nrow)
    solve_basis = x[perm]
    np.testing.assert_array_equal(tio.unpermute(torch.from_numpy(solve_basis), perm), x)
    np.testing.assert_array_equal(tio.unpermute(solve_basis, perm), jio.unpermute(solve_basis, perm))
    np.testing.assert_array_equal(tio.unpermute(x, None), x)
    # the operator in the solve basis, applied to a permuted vector, is the
    # permuted product
    y = prob.A.matvec(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(op.matvec(torch.from_numpy(solve_basis)).numpy(), y[perm], rtol=1e-14, atol=0)


def test_reader_rejects_malformed_files(tmp_path):
    path = tmp_path / "bad.txt"
    for text in ("", "3 4\n1 1 1\n", "2 2\n1 1\n1.0 0\n"):
        path.write_text(text)
        with pytest.raises(ValueError):
            tio.read_hpc_row(str(path), device="cpu")


def test_scattered_ell_chooses_like_its_byte_rule():
    """A narrow scattered band: RCM cannot make DIA stream fewer bytes than
    ELL, so it stays ELL; a stencil stays DIA."""
    rng = np.random.default_rng(10)
    n, w = 500, 5
    cols = np.clip(np.arange(n)[:, None] + rng.integers(-20, 21, (n, w)), 0, n - 1).astype(np.int32)
    cols[:, 0] = np.arange(n)
    vals = np.where(cols == np.arange(n)[:, None], 10.0, -0.5)
    A = ell_from_numpy(vals, cols, np.ones((n, w), bool), 0, n, device="cpu")
    _, _, report = auto_structure(A)
    assert report.format.startswith("ell"), report
    _, perm, report = auto_structure(_stencil_problem().A)
    assert report.format == "dia" and perm is None
