"""The wide-scatter layouts of the port's ELL gather against the JAX
package's wide-scatter tiers, on the CPU.

The plain version of both forms, relabelled (K13's kernel,
``ops/cuda/ell.py::ScatterEll``: the rows in reverse Cuthill-McKee order and
x relabelled the same way) and in place (K11/K12's slot-major layout, which
runs K14's class), against ``spmv_gell_stack`` / ``spmv_gell_dynwin``
(K13/K14) and their double-float forms in interpret mode, on a randomly
permuted 16^3 stencil and a random wide scatter of 10^4 rows; the chooser
(``prepare_ell`` and ``reorder.relabel_order``, with its pre-test); a
``make_cg`` solve of the permuted stencil as loaded against JAX's solve;
and the ell-allgather tier at 4 CPU ranks on it against JAX's.

The wrapper is called on CPU tensors, where it runs the plain version and
counts no launch. Tolerances: the matvecs as in test_torch_explicit.py,
max|port - jax| / max|jax| within 1e-5 in float32 and 1e-13 in float64;
the solves (float64) as test_torch_file_solve.py holds an explicit
matrix's: niters equal, the trace within 1e-10 above 1e-11 of trace[0]
(below it the recurrence residual follows each run's sums), x within 1e-10
of max|x|; the all-gather tier's trace within 1e-9, as
test_torch_distributed_file.py holds the tiers.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import hpccg_tpu  # noqa: E402
import hpccg_tpu.operators as jops  # noqa: E402
from hpccg_tpu.models.stencil import generate_ell as jgenerate_ell  # noqa: E402
from hpccg_tpu.ops.pallas.gell_dynwin import (  # noqa: E402
    prepare_gell_dynwin,
    spmv_gell_dynwin,
    spmv_gell_dynwin_dd,
)
from hpccg_tpu.ops.pallas.gell_stack import (  # noqa: E402
    prepare_gell_stack,
    spmv_gell_stack,
    spmv_gell_stack_dd,
)
from hpccg_tpu.parallel import make_distributed_ell_cg as jmake_ell  # noqa: E402
from hpccg_tpu.parallel import make_mesh as jmake_mesh  # noqa: E402
from hpccg_tpu.reorder import permute_ell as jpermute_ell  # noqa: E402
from hpccg_tpu.solver import make_cg as jmake_cg  # noqa: E402
from hpccg_tpu_torch import ProblemConfig, make_cg  # noqa: E402
from hpccg_tpu_torch.convert import ell_from_numpy, explicit_problem_from_numpy, shards_to_numpy  # noqa: E402
from hpccg_tpu_torch.models.stencil import generate_ell  # noqa: E402
from hpccg_tpu_torch.operators import EllMatrix  # noqa: E402
from hpccg_tpu_torch.ops.cuda import ell as cell  # noqa: E402
from hpccg_tpu_torch.parallel import cg as pcg  # noqa: E402
from hpccg_tpu_torch.parallel import make_mesh  # noqa: E402
from hpccg_tpu_torch import reorder  # noqa: E402
from hpccg_tpu_torch.reorder import permute_ell, rcm_permutation  # noqa: E402

RTOL = {np.dtype(np.float32): 1e-5, np.dtype(np.float64): 1e-13}
FORMS = {"relabelled": True, "in place": False}


def _close(got, want):
    got, want = got.numpy(), np.asarray(want)
    assert got.dtype == want.dtype
    err = np.max(np.abs(got - want)) / np.max(np.abs(want))
    assert err <= RTOL[want.dtype], err


def _permuted_stencil(dtype, seed, dims=(16, 16, 16)):
    """A randomly permuted stencil (wide scatter), as a host-array
    EllMatrix."""
    A = jgenerate_ell(hpccg_tpu.ProblemConfig(*dims, dtype=getattr(jnp, dtype))).A
    A = jops.EllMatrix(vals=np.asarray(A.vals), cols=np.asarray(A.cols), valid=np.asarray(A.valid),
                       start_row=0, total_nrow=A.local_nrow)
    return jpermute_ell(A, np.random.default_rng(seed).permutation(A.local_nrow))


def _wide_scatter(n, per_row, bw, seed, dtype="float32"):
    """A random wide band (as tests/test_gell_stack.py builds it): a dominant
    diagonal slot and 15% invalid slots."""
    rng = np.random.default_rng(seed)
    cols = np.clip(np.arange(n)[:, None] + rng.integers(-bw, bw + 1, (n, per_row)), 0, n - 1)
    cols[:, 0] = np.arange(n)
    vals = rng.uniform(-1.0, -0.1, (n, per_row))
    vals[:, 0] = per_row + 1.0
    valid = np.ones((n, per_row), bool)
    valid[rng.random((n, per_row)) < 0.15] = False
    valid[:, 0] = True
    return jops.EllMatrix(vals=np.where(valid, vals, 0.0).astype(dtype), cols=cols.astype(np.int32),
                          valid=valid, start_row=0, total_nrow=n)


def _port(jA):
    return ell_from_numpy(np.asarray(jA.vals), np.asarray(jA.cols), np.asarray(jA.valid), 0, jA.local_nrow,
                          device="cpu")


def _x(n, dtype, seed=0):
    return np.random.default_rng(seed).standard_normal(n).astype(dtype)


@functools.cache
def _jax_case(case):
    """(matrix, x, {tier: JAX's y}) of a float32 case, the tiers in
    interpret mode."""
    if case == "permuted_stencil":
        jA = _permuted_stencil("float32", 4)
    else:
        jA = _wide_scatter(10000, 9, 3000, seed=1)
    x = _x(jA.local_nrow, np.float32, seed=4)
    S = prepare_gell_stack(jA, strip_chunks=16)
    assert len(S.strips) > 1
    want = {"stack": spmv_gell_stack(S, jnp.asarray(x), interpret=True),
            "dynwin": spmv_gell_dynwin(prepare_gell_dynwin(jA, K=16), jnp.asarray(x), interpret=True)}
    return jA, x, want


@functools.cache
def _jax_case_dd():
    jA = _wide_scatter(4096, 5, 1500, seed=11, dtype="float64")
    x = _x(jA.local_nrow, np.float64, seed=6)
    S = prepare_gell_stack(jA, strip_chunks=8)
    D = prepare_gell_dynwin(jA, K=8)
    assert S.vals3lo is not None and D.vals4lo is not None
    want = {"stack": spmv_gell_stack_dd(S, jnp.asarray(x), interpret=True),
            "dynwin": spmv_gell_dynwin_dd(D, jnp.asarray(x), interpret=True)}
    return jA, x, want


def _form(A, relabel):
    """The relabelled layout (K13) in A's RCM order, or K11/K12's."""
    return cell.prepare_scatter(A, rcm_permutation(A)) if relabel else cell.ell_slots(A)


def _launches():
    f = cell.spmv_ell
    return (f.launches_f32, f.launches_f64, f.launches_scatter_f32, f.launches_scatter_f64)


def _scatter_plain(jA, x, relabel):
    S = _form(_port(jA), relabel)
    assert type(S) is (cell.ScatterEll if relabel else cell.EllSlots)
    before = _launches()
    y = cell.spmv_ell(S, torch.from_numpy(x))
    assert _launches() == before
    return y


@pytest.mark.parametrize("tier", ["stack", "dynwin"])
@pytest.mark.parametrize("form", list(FORMS))
@pytest.mark.parametrize("case", ["permuted_stencil", "wide_scatter"])
def test_scatter_plain_matches_jax_tiers(case, form, tier):
    """K13 (strip stack) and K14 (dynamic window) in float32."""
    jA, x, want = _jax_case(case)
    _close(_scatter_plain(jA, x, FORMS[form]), want[tier])


@pytest.mark.parametrize("tier", ["stack", "dynwin"])
@pytest.mark.parametrize("form", list(FORMS))
def test_scatter_plain_matches_jax_dd_tiers(form, tier):
    """The double-float tiers (f64 as (hi, lo) f32 pairs) against the
    layout's float64 plain version."""
    jA, x, want = _jax_case_dd()
    _close(_scatter_plain(jA, x, FORMS[form]), want[tier])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("form", list(FORMS))
def test_scatter_plain_gives_k11_bits(form, dtype):
    """Each form sums a row's slots in K11's order on the same values: the
    plain version gives K11's plain version's bits (the kernels the same,
    on the card), and so does the layout the chooser takes."""
    prob = generate_ell(ProblemConfig(16, 16, 16, dtype=dtype), "cpu")
    A = permute_ell(prob.A, np.random.default_rng(2).permutation(prob.total_nrow))
    x = torch.from_numpy(_x(A.local_nrow, np.float64, seed=3)).to(dtype)
    want = cell.spmv_ell(cell.ell_slots(A), x)
    assert torch.equal(cell.spmv_ell(_form(A, FORMS[form]), x), want)
    assert torch.equal(cell.spmv_ell(cell.prepare_ell(A), x), want)


def test_relabelled_layout_is_the_rcm_order():
    """The relabelled form's rows are A's RCM order and its columns the
    positions of the old ones in that order; x'[j] = x[order[j]]."""
    prob = generate_ell(ProblemConfig(6, 5, 4), "cpu")
    A = permute_ell(prob.A, np.random.default_rng(5).permutation(prob.total_nrow))
    perm = rcm_permutation(A)
    S = cell.prepare_scatter(A, perm)
    np.testing.assert_array_equal(S.order.numpy(), perm)
    inv = np.argsort(perm)
    np.testing.assert_array_equal(S.cols.t().numpy(), inv[A.cols.numpy()][perm])
    np.testing.assert_array_equal(S.vals.t().numpy(), A.vals.numpy()[perm])


def _chooser_case(case):
    if case.startswith("stencil"):
        A = generate_ell(ProblemConfig(16, 16, 16), "cpu").A
        return permute_ell(A, rcm_permutation(A)) if case == "stencil after RCM" else A
    if case.startswith("permuted"):
        g = int(case.split()[1][:2])
        A = generate_ell(ProblemConfig(g, g, g, dtype=torch.float32), "cpu").A
        A = permute_ell(A, np.random.default_rng(7).permutation(A.local_nrow))
        return cell.dataclasses.replace(A, vals=A.vals.to(torch.bfloat16)) if case.endswith("bf16") else A
    return _port(_wide_scatter(100_000, 9, 50_000, seed=3))


@pytest.mark.parametrize("case, want", [("stencil 16^3", cell.EllSlots), ("stencil after RCM", cell.EllSlots),
                                        ("permuted 48^3", "relabelled"), ("permuted 16^3", "in place"),
                                        ("permuted 48^3 bf16", cell.EllSlots), ("wide scatter n=1e5", "in place")])
def test_chooser(case, want):
    """Banded matrices keep K11's layout; a scattered square matrix takes
    the relabelled one (float32 and float64 only) where x is wide and RCM
    shrinks the span of x a group gathers from (the permuted 48^3 stencil),
    and stays on K11's layout, gathered in place, where x is narrow (16^3)
    or RCM cannot shrink it (a random band)."""
    A = _chooser_case(case)
    S = cell.prepare_ell(A)
    span = reorder.group_span(A.cols, A.valid, A.vals.element_size())
    if want == "relabelled":
        assert type(S) is cell.ScatterEll and span >= reorder.RELABEL_SPAN
        np.testing.assert_array_equal(S.order.numpy(), rcm_permutation(A))
        return
    assert type(S) is cell.EllSlots
    if want == "in place":
        assert (span < reorder.RELABEL_SPAN) == case.startswith("permuted")


def test_relabel_pretest_keeps_a_random_band_off_the_host(monkeypatch):
    """A random band's breadth-first search is a few levels deep, so the
    pre-test rules the relabel out before the host's RCM is computed; a
    permuted stencil's is deep, and passes it."""

    def refuse(A):
        raise AssertionError("RCM computed")

    band = _chooser_case("wide scatter n=1e5")
    stencil = _chooser_case("permuted 48^3")
    size = 4
    assert reorder.group_span(band.cols, band.valid, size) >= reorder.RELABEL_SPAN
    assert 3 * band.local_nrow * size * reorder.RELABEL_GAIN > (reorder.group_span(band.cols, band.valid, size)
                                                                  * reorder.bfs_depth(band))
    assert reorder.bfs_depth(stencil) == 47  # the 48^3 grid's diameter
    monkeypatch.setattr(reorder, "rcm_permutation", refuse)
    assert reorder.relabel_order(band) is None
    with pytest.raises(AssertionError, match="RCM computed"):
        reorder.relabel_order(stencil)


def test_relabel_order_needs_a_square_float_matrix():
    """bf16 and a rank's block (global columns, ncols != n) keep their
    order; the relabelled layout refuses a block."""
    A = _chooser_case("permuted 48^3")
    assert reorder.relabel_order(A) is not None
    assert reorder.relabel_order(cell.dataclasses.replace(A, vals=A.vals.to(torch.bfloat16))) is None
    n = A.local_nrow
    blk = EllMatrix(vals=A.vals[: n // 2], cols=A.cols[: n // 2], valid=A.valid[: n // 2], start_row=0, total_nrow=n)
    assert reorder.relabel_order(blk) is None
    with pytest.raises(ValueError, match="square"):
        cell.prepare_scatter(blk, np.arange(n // 2))


def _jax_permuted_problem():
    """The permuted 16^3 float64 problem (b = A 1) in both packages."""
    jA = _permuted_stencil("float64", 9)
    xex = np.ones(jA.local_nrow)
    b = np.array(jA.matvec(jnp.asarray(xex)))
    return jA, b


def _held(res, jres, x, rtol):
    jt = np.asarray(jres.trace)
    assert int(res.niters) == int(jres.niters) == 39
    head = jt > 1e-11 * jt[0]
    assert head[:10].all()
    np.testing.assert_allclose(res.trace.numpy()[head], jt[head], rtol=rtol)
    jx = np.asarray(jres.x)
    assert np.max(np.abs(x - jx)) <= 1e-10 * np.max(np.abs(jx))


@pytest.mark.parametrize("form", list(FORMS))
def test_make_cg_on_the_permuted_stencil_matches_jax(monkeypatch, form):
    """make_cg on the permuted 16^3 stencil as loaded: on K11's layout, in
    place, as the chooser takes it, and relabelled (the relabel rule's
    threshold on x's span lowered for a 16^3 matrix); against JAX's
    solve."""
    if FORMS[form]:
        monkeypatch.setattr(reorder, "RELABEL_SPAN", 0)
    jA, b = _jax_permuted_problem()
    A = _port(jA)
    S = cell.prepare_ell(A)
    assert type(S) is (cell.ScatterEll if FORMS[form] else cell.EllSlots)
    tb = torch.from_numpy(b)
    res = make_cg(A, max_iter=40, tolerance=0.0)(tb, torch.zeros_like(tb))
    jres = jmake_cg(jA, max_iter=40, tolerance=0.0)(jnp.asarray(b), jnp.zeros_like(jnp.asarray(b)))
    _held(res, jres, res.x.numpy(), 1e-10)


def test_ell_allgather_tier_on_the_permuted_stencil():
    """The ell-allgather tier at 4 CPU ranks on the permuted 16^3 stencil:
    each rank's rows (global columns, ncols = n) are gathered in place, on
    K11/K12's layout; against JAX's all-gather tier on 4 devices."""
    jA, b = _jax_permuted_problem()
    mesh = make_mesh(4, devices=["cpu"] * 4)
    n = jA.local_nrow
    arrays = {"vals": np.asarray(jA.vals), "cols": np.asarray(jA.cols), "valid": np.asarray(jA.valid),
              "total_nrow": n}
    prob = explicit_problem_from_numpy(arrays, b, np.zeros(n), np.ones(n), device="cpu", mesh=mesh)
    layouts = [cell.prepare_ell(blk) for blk in pcg.shard_matrix(prob.A, mesh)]
    assert all(type(S) is cell.EllSlots and S.ncols == n for S in layouts)
    res = pcg.make_distributed_ell_cg(mesh, max_iter=40)(prob.A, prob.b, prob.x0)
    jres = jmake_ell(jmake_mesh(4), max_iter=40)(jA, jnp.asarray(b), jnp.zeros((n,)))
    _held(res, jres, shards_to_numpy(res.x), 1e-9)
