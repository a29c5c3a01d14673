"""Distributed file mode of the port (a loaded explicit matrix, rows
block-sharded over a single-controller mesh of CPU ranks) against the JAX
package's, on the CPU.

The same matrices, made from a seed with numpy, go to both packages. The
port's tiers run their kernels' plain versions here (K9/K10 on each rank's
extended vector, K11/K12); the JAX side runs its ppermute and all-gather
tiers on its virtual CPU devices.

Tolerances (float64), the JAX package's own for its distributed file mode
(tests/test_distributed_file.py): niters equal; trace rtol 1e-9 above
1e-12 * trace[0]; x rtol 1e-9, atol 1e-12. cg1 and pipecg as
tests/test_torch_methods.py holds them: rtol 1e-10 above 1e-11 for cg1,
1e-6 above 1e-9 for pipecg (its w and z recurrences carry each run's
rounding forward), x within 1e-9.
"""

import dataclasses
import io
import json
from contextlib import redirect_stderr, redirect_stdout

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import hpccg_tpu.io as jio  # noqa: E402
from hpccg_tpu.cli import main as jax_main  # noqa: E402
from hpccg_tpu.models.stencil import Problem as JProblem  # noqa: E402
from hpccg_tpu.operators import DiaMatrix as JDia  # noqa: E402
from hpccg_tpu.parallel import make_distributed_dia_cg as jmake_dia  # noqa: E402
from hpccg_tpu.parallel import make_distributed_ell_cg as jmake_ell  # noqa: E402
from hpccg_tpu.parallel import make_mesh as jmake_mesh  # noqa: E402
from hpccg_tpu.parallel.cg import collective_dia_supported as jcollective_dia_supported  # noqa: E402
from hpccg_tpu.parallel.cg import dia_halo_plan as jdia_halo_plan  # noqa: E402
from hpccg_tpu_torch import ProblemConfig  # noqa: E402
from hpccg_tpu_torch import io as tio  # noqa: E402
from hpccg_tpu_torch.cli import main  # noqa: E402
from hpccg_tpu_torch.convert import (  # noqa: E402
    dia_to_numpy,
    ell_to_numpy,
    explicit_problem_from_numpy,
    explicit_problem_to_numpy,
    shards_to_numpy,
)
from hpccg_tpu_torch.models.stencil import generate_ell  # noqa: E402
from hpccg_tpu_torch.operators import DiaRows, EllMatrix  # noqa: E402
from hpccg_tpu_torch.parallel import cg as pcg  # noqa: E402
from hpccg_tpu_torch.parallel import make_mesh  # noqa: E402
from hpccg_tpu_torch.reorder import permute_ell  # noqa: E402

OFFSETS = (-13, -5, -1, 0, 1, 5, 13)
TRACE = {"cg": (1e-9, 1e-12), "cg1": (1e-10, 1e-11), "pipecg": (1e-6, 1e-9)}  # (rtol, floor)


def _banded(n, offsets, seed=0, dtype=np.float64):
    """Numpy DIA data of a diagonally dominant banded matrix (the JAX
    package's tests/test_distributed_file.py:_banded)."""
    rng = np.random.default_rng(seed)
    data = np.zeros((len(offsets), n), dtype)
    for d, off in enumerate(offsets):
        lo, hi = max(0, -off), min(n, n - off)
        data[d, lo:hi] = 2.0 * len(offsets) if off == 0 else rng.uniform(-1, -0.1, hi - lo)
    return data


def _jax_problem(n, offsets, seed=0, fmt="dia"):
    A = JDia(data=jnp.asarray(_banded(n, offsets, seed)), offsets=tuple(offsets), total_nrow=n)
    xex = jnp.ones((n,), jnp.float64)
    b = A.matvec(xex)
    A = A.to_ell() if fmt == "ell" else A
    return JProblem(A=A, b=b, x0=jnp.zeros_like(b), xexact=xex, total_nrow=n, total_nnz_model=int(A.nnz),
                    total_nnz_exact=int(A.nnz))


def _arrays(A) -> dict:
    if hasattr(A, "offsets"):
        return {"data": np.asarray(A.data), "offsets": A.offsets, "total_nrow": A.total_nrow}
    return {"vals": np.asarray(A.vals), "cols": np.asarray(A.cols), "valid": np.asarray(A.valid),
            "total_nrow": A.total_nrow}


def _port_problem(jprob, mesh=None):
    return explicit_problem_from_numpy(_arrays(jprob.A), np.asarray(jprob.b), np.asarray(jprob.x0),
                                       np.asarray(jprob.xexact), device="cpu", mesh=mesh)


def _held(res, jres, method="cg"):
    rtol, floor = TRACE[method]
    jt = np.asarray(jres.trace)
    assert int(res.niters) == int(jres.niters)
    head = np.isfinite(jt) & (jt > floor * jt[0])
    assert head[:10].all()
    np.testing.assert_allclose(res.trace.numpy()[head], jt[head], rtol=rtol)
    np.testing.assert_allclose(shards_to_numpy(res.x), np.asarray(jres.x), rtol=1e-9, atol=1e-12)


# ------------------------------------------------------------------ padding


@pytest.mark.parametrize("case", ["ell", "dia", "dia without offset 0"])
def test_pad_problem_rows_matches_jax(case):
    """n = 250 padded to a multiple of 8: identity pad rows with b = x0 =
    xexact = 0, a zero diagonal inserted at offset 0 where the band lacks
    one; the arrays equal JAX's."""
    offsets = (-3, -1, 1, 3) if case == "dia without offset 0" else (-3, -1, 0, 1, 3)
    jprob = _jax_problem(250, offsets, seed=2, fmt="ell" if case == "ell" else "dia")
    jpad = jio.pad_problem_rows(jprob, 8)
    pad = tio.pad_problem_rows(_port_problem(jprob), 8)
    assert pad.total_nrow == jpad.total_nrow == 256
    assert (pad.total_nnz_model, pad.total_nnz_exact) == (jpad.total_nnz_model, jpad.total_nnz_exact)
    got = dia_to_numpy(pad.A) if case != "ell" else ell_to_numpy(pad.A)
    want = _arrays(jpad.A)
    for key in want:
        np.testing.assert_array_equal(np.asarray(got[key]), np.asarray(want[key]), err_msg=key)
    for name in ("b", "x0", "xexact"):
        np.testing.assert_array_equal(getattr(pad, name).numpy(), np.asarray(getattr(jpad, name)))
    assert tio.pad_problem_rows(pad, 8) is pad  # already divisible


def test_padding_keeps_the_trajectory():
    """The padded problem on 8 ranks follows the unpadded single-device
    trajectory; the pad rows solve to exactly 0 (JAX's
    test_distributed_dia_with_remainder_padding)."""
    from hpccg_tpu_torch import make_cg

    prob = _port_problem(_jax_problem(250, (-3, -1, 0, 1, 3), seed=2))
    single = make_cg(prob.A, max_iter=40)(prob.b, prob.x0)
    pad = tio.pad_problem_rows(prob, 8)
    res = pcg.make_distributed_dia_cg(make_mesh(8, devices=["cpu"] * 8), max_iter=40)(pad.A, pad.b, pad.x0)
    assert int(res.niters) == int(single.niters) == 39
    head = single.trace > 1e-12 * single.trace[0]
    torch.testing.assert_close(res.trace[head], single.trace[head], rtol=1e-9, atol=0)
    x = torch.cat(res.x)
    torch.testing.assert_close(x[:250], single.x, rtol=1e-9, atol=1e-12)
    assert torch.equal(x[250:], torch.zeros(6, dtype=torch.float64))


# ------------------------------------------------------- sharding and plans


@pytest.mark.parametrize("fmt", ["dia", "ell"])
def test_shard_problem_blocks(fmt):
    """shard_problem: DiaRows (ndiag, L) column blocks or ELL row blocks with
    global columns, each on its rank's device, and the way back."""
    jprob = _jax_problem(240, OFFSETS, fmt=fmt)
    mesh = make_mesh(4, devices=["cpu"] * 4)
    prob = _port_problem(jprob, mesh)
    assert len(prob.A) == 4 and all(isinstance(blk, DiaRows if fmt == "dia" else EllMatrix) for blk in prob.A)
    assert [blk.start_row for blk in prob.A] == [0, 60, 120, 180]
    assert all(blk.local_nrow == 60 and blk.total_nrow == 240 for blk in prob.A)
    if fmt == "dia":
        assert (prob.A[1].bw_lo, prob.A[1].bw_hi) == (13, 13)
        np.testing.assert_array_equal(prob.A[2].data.numpy(), np.asarray(jprob.A.data)[:, 120:180])
    else:
        np.testing.assert_array_equal(prob.A[3].cols.numpy(), np.asarray(jprob.A.cols)[180:])
        assert pcg.ell_band(prob.A) == (13, 13)
    back = explicit_problem_to_numpy(prob)
    for key, want in _arrays(jprob.A).items():
        np.testing.assert_array_equal(np.asarray(back["A"][key]), np.asarray(want), err_msg=key)
    np.testing.assert_array_equal(back["b"], np.asarray(jprob.b))
    with pytest.raises(ValueError, match="pad_problem_rows"):
        pcg.shard_problem(_port_problem(_jax_problem(250, OFFSETS)), mesh)


def test_plans_refuse_a_band_wider_than_the_shard():
    """n = 64 on 8 ranks (L = 8) with a band of 40: refused by the dia-halo
    and collective predicates and the solvers, as JAX's are
    (tests/test_distributed_file.py:86-92)."""
    jprob = _jax_problem(64, (-40, 0, 40))
    mesh = make_mesh(8, devices=["cpu"] * 8)
    prob = _port_problem(jprob)
    ok, reason = pcg.dia_halo_plan(prob.A, 8)
    assert not ok and "bandwidth (40/40) exceeds the 8-row shard" in reason
    assert not jdia_halo_plan(jprob.A, 8)[0]
    ok, reason = pcg.collective_dia_supported(prob.A, mesh)
    assert not ok and "bandwidth" in reason and "make_distributed_ell_cg" in reason
    assert not jcollective_dia_supported(jprob.A, 8)[0]
    assert not pcg.ell_halo_plan(prob.A.to_ell(), 8)[0]
    with pytest.raises(ValueError, match="bandwidth"):
        pcg.make_distributed_dia_cg(mesh, max_iter=5)(prob.A, prob.b, prob.x0)
    with pytest.raises(ValueError, match="bandwidth"):
        pcg.make_distributed_ell_halo_cg(mesh, max_iter=5)(prob.A.to_ell(), prob.b, prob.x0)
    with pytest.raises(ValueError, match="bandwidth"):
        pcg.make_collective_dia_cg(mesh, max_iter=5)(prob.A, prob.b, prob.x0)
    # the all-gather tier takes any band
    res = pcg.make_distributed_ell_cg(mesh, max_iter=5)(prob.A.to_ell(), prob.b, prob.x0)
    assert int(res.niters) == 4
    # a band as wide as the shard is taken
    assert pcg.dia_halo_plan(prob.A, 40)[0] and pcg.ell_halo_plan(prob.A.to_ell(), 40)[0]


# ----------------------------------------------------------- tiers vs JAX


TIERS = {"dia-halo": (pcg.make_distributed_dia_cg, "dia", jmake_dia),
         "ell-halo": (pcg.make_distributed_ell_halo_cg, "ell", jmake_ell),
         "ell-allgather": (pcg.make_distributed_ell_cg, "ell", jmake_ell)}


@pytest.mark.parametrize("ndev", [1, 2, 4, 8])
@pytest.mark.parametrize("tier", list(TIERS))
def test_tier_matches_jax(tier, ndev):
    """Each tier against JAX's distributed solve of the same f64 matrix (n =
    240, 7 diagonals within +-13) on ndev ranks, 40 iterations."""
    make, fmt, jmake = TIERS[tier]
    jprob = _jax_problem(240, OFFSETS, fmt=fmt)
    jres = jmake(jmake_mesh(ndev), max_iter=40)(jprob.A, jprob.b, jprob.x0)
    mesh = make_mesh(ndev, devices=["cpu"] * ndev)
    prob = _port_problem(jprob, mesh)
    res = make(mesh, max_iter=40)(prob.A, prob.b, prob.x0)
    _held(res, jres)
    assert int(res.niters) == 39


@pytest.mark.parametrize("method", ["cg1", "pipecg"])
def test_methods_on_the_dia_halo_tier(method):
    """cg1 and pipecg on dia-halo, 4 ranks, against JAX's distributed DIA
    solve with the same method; and with residual replacement every 7. 15
    iterations: at k = 15 the trace is 1.3e-11 of trace[0], the floor below
    which a one-reduction recurrence residual follows each run's sums (the
    port's cg1 parted from JAX's by 2.5e-6 there, 4 ranks)."""
    jprob = _jax_problem(240, OFFSETS)
    mesh = make_mesh(4, devices=["cpu"] * 4)
    prob = _port_problem(jprob, mesh)
    for rr in (0, 7):
        jres = jmake_dia(jmake_mesh(4), max_iter=15, method=method, replace_every=rr)(jprob.A, jprob.b, jprob.x0)
        res = pcg.make_distributed_dia_cg(mesh, max_iter=15, method=method, replace_every=rr)(prob.A, prob.b,
                                                                                             prob.x0)
        _held(res, jres, method)


def test_ell_halo_takes_a_permuted_band():
    """The ell-halo tier on a permuted stencil after RCM (the class the JAX
    package's gell-halo tier serves), 2 ranks, against the ell-allgather
    tier and the single-device ELL solve: the same trajectory."""
    from hpccg_tpu_torch import make_cg
    from hpccg_tpu_torch.reorder import rcm_permutation

    prob = generate_ell(ProblemConfig(6, 5, 8), "cpu")
    perm = np.random.default_rng(5).permutation(prob.total_nrow)
    A = permute_ell(prob.A, perm)
    A = permute_ell(A, rcm_permutation(A))
    b = A.matvec(torch.ones(prob.total_nrow, dtype=torch.float64))
    x0 = torch.zeros_like(b)
    mesh = make_mesh(2, devices=["cpu"] * 2)
    assert pcg.ell_halo_plan(A, 120)[0]
    single = make_cg(A, max_iter=30)(b, x0)
    for make in (pcg.make_distributed_ell_halo_cg, pcg.make_distributed_ell_cg):
        res = make(mesh, max_iter=30)(A, b, x0)
        assert int(res.niters) == int(single.niters)
        head = single.trace > 1e-12 * single.trace[0]
        torch.testing.assert_close(res.trace[head], single.trace[head], rtol=1e-9, atol=0)


def test_spmv_bench_steps_run_each_tier():
    """make_distributed_spmv_bench: one step applies each rank's kernel to
    its extended vector (or the gathered x); unknown tiers raise."""
    A = _port_problem(_jax_problem(240, OFFSETS)).A
    mesh = make_mesh(2, devices=["cpu"] * 2)
    for tier, M in (("dia-halo", A), ("dia-collective", A), ("ell-halo", A.to_ell()), ("ell-allgather", A.to_ell())):
        pcg.make_distributed_spmv_bench(mesh, M, tier)()
    with pytest.raises(ValueError, match="unknown distributed file tier"):
        pcg.make_distributed_spmv_bench(mesh, A, "gell")


# ----------------------------------------------------------------- the CLI


def _write(path, dims, permute_seed=None):
    prob = generate_ell(ProblemConfig(*dims), "cpu")
    if permute_seed is not None:
        perm = np.random.default_rng(permute_seed).permutation(prob.total_nrow)
        index = torch.from_numpy(perm)
        prob = dataclasses.replace(prob, A=permute_ell(prob.A, perm), b=prob.b[index], xexact=prob.xexact[index])
    tio.write_hpc_row(str(path), prob)
    return str(path)


def _run(fn, args):
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        assert fn(args) == 0
    text = out.getvalue()
    return json.loads(text[text.index("{"):]), err.getvalue()


@pytest.mark.parametrize("case,tier", [("banded", "dia-halo"), ("permuted", "ell-halo")])
def test_cli_file_mesh_matches_jax(tmp_path, case, tier):
    """FILE --mesh 2 through both CLIs: a 5x4x16 stencil file (DIA, band 21
    within 160-row shards) and a permuted 8x7x6 one (ELL after RCM): the
    tier label, the iterations and the final residual agree with the JAX
    solve (whose label for the permuted file is its gather tier's); --check
    in the file's basis."""
    path = _write(tmp_path / "m.txt", (5, 4, 16) if case == "banded" else (8, 7, 6),
                  None if case == "banded" else 12)
    base = [path, "--mesh", "2", "--max-iter", "20", "--json", "--quiet", "--skip-kernel-bench", "--check"]
    rep, err = _run(main, base + ["--device", "cpu"])
    jrep, _ = _run(jax_main, base)
    note = next(k for k in rep["Time Summary"] if k.startswith("("))
    assert f"backend=distributed:{tier}" in note
    assert rep["Parallelism"]["Number of mesh devices"] == jrep["Parallelism"]["Number of mesh devices"] == 2
    assert rep["Number of iterations"] == jrep["Number of iterations"] == 19
    np.testing.assert_allclose(rep["Final residual"], jrep["Final residual"], rtol=1e-9, atol=1e-13)
    assert rep["Difference between computed and exact"] < 1e-9
    assert "# matrix structure: " in err


def test_cli_file_mesh_fallbacks_and_collective(tmp_path):
    """The CLI's tier order on the CPU: --backend collective on a DIA file
    runs dia-collective (K17's plain version; pipecg runs cg1, --rr-every
    is ignored, each said on stderr); a band wider than the shard falls
    back to ell-allgather with the reason; the results match the
    single-device solve of the file."""
    path = _write(tmp_path / "short.txt", (5, 4, 7))
    # 8 iterations: still above the f64 floor, where the residuals of two sum orders agree
    base = [path, "--max-iter", "8", "--json", "--quiet", "--skip-kernel-bench", "--device", "cpu"]
    one, _ = _run(main, base)
    rep, err = _run(main, base + ["--mesh", "3", "--backend", "collective", "--method", "pipecg", "--rr-every", "5"])
    assert "ignoring --method pipecg (running cg1)" in err and "--rr-every does not apply" in err
    assert any("backend=distributed:dia-collective" in k for k in rep["Time Summary"])
    assert rep["Number of iterations"] == 7
    rep, err = _run(main, base + ["--mesh", "3", "--backend", "collective", "--method", "cg"])
    assert "reference cg recurrence" in err
    np.testing.assert_allclose(rep["Final residual"], one["Final residual"], rtol=1e-9)
    rep, err = _run(main, base + ["--mesh", "8", "--backend", "collective"])
    assert "collective unavailable: bandwidth (26/26) exceeds the 18-row shard" in err
    assert "using the all-gather ELL path" in err
    assert any("backend=distributed:ell-allgather" in k for k in rep["Time Summary"])
    assert rep["Number of iterations"] == one["Number of iterations"]
    rep, err = _run(main, base + ["--mesh", "2", "--backend", "stencil", "--validate"])
    assert "ignoring --backend stencil" in err and "# problem validated" in err


def test_cli_file_mesh_kernel_bench(tmp_path):
    """The SPARSEMV row at --mesh 2 in file mode: the tier's per-rank kernel,
    the exchange timed apart, named in the note."""
    path = _write(tmp_path / "b.txt", (4, 3, 12))
    rep, _ = _run(main, [path, "--mesh", "2", "--max-iter", "6", "--json", "--quiet", "--device", "cpu"])
    ts = rep["Time Summary"]
    note = next(k for k in ts if k.startswith("("))
    assert "K9/K10 DIA kernel on each rank's extended vector" in note and "on 2 ranks" in note
    assert ts["SPARSEMV"] >= 0 and ts["DDOT    "] >= 0
    assert "global nz" not in rep["Dimensions"]
