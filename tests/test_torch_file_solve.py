"""The explicit-matrix path as a whole, against the JAX package and the
reference's golden run, on the CPU: an HPC-row file read by both packages,
solved by each package's ``make_cg`` and run through each CLI.

Trajectories (tolerance 0): in float64 niters are equal and the trace
within 1e-10 while it stays above 1e-11 of trace[0]; in float32 the trace
within 1e-5 above 1e-5 of trace[0], and niters are not compared (small f32
solves flush r.r to 0 at rounding-dependent iterations, ROADMAP queue 3).
Below those floors the recurrence residual follows each run's rounding
(tests/test_torch_solver.py). x is compared in the file's basis, after
``unpermute``, within 1e-10 (f64) / 1e-4 (f32) of max|x|. The two packages
may pick other representations of one file (the port has no TPU gather
tiers) and other RCM orders (the JAX package prefers its native one): CG
is basis-invariant, so the traces still agree above the floors.
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
from hpccg_tpu.solver import make_cg as jmake_cg  # noqa: E402
from hpccg_tpu_torch import ProblemConfig, make_cg  # noqa: E402
from hpccg_tpu_torch import io as tio  # noqa: E402
from hpccg_tpu_torch.cli import main  # noqa: E402
from hpccg_tpu_torch.models.stencil import generate_ell  # noqa: E402
from hpccg_tpu_torch.operators import DiaMatrix, EllMatrix  # noqa: E402
from hpccg_tpu_torch.reorder import permute_ell  # noqa: E402

from oracle import GOLDEN_10_NITERS, GOLDEN_10_TRACE  # noqa: E402

TRACE = {"float64": (1e-10, 1e-11), "float32": (1e-5, 1e-5)}  # (rtol, floor)
X_RTOL = {"float64": 1e-10, "float32": 1e-4}


def _write(path, dims, dtype="float64", permute_seed=None):
    prob = generate_ell(ProblemConfig(*dims, dtype=getattr(torch, dtype)), "cpu")
    if permute_seed is not None:
        perm = np.random.default_rng(permute_seed).permutation(prob.total_nrow)
        index = torch.from_numpy(perm)
        prob = dataclasses.replace(prob, A=permute_ell(prob.A, perm), b=prob.b[index], xexact=prob.xexact[index])
    tio.write_hpc_row(str(path), prob)
    return str(path)


def _golden_checks(trace, niters):
    assert niters == GOLDEN_10_NITERS
    np.testing.assert_allclose(trace[0], GOLDEN_10_TRACE[0], rtol=1e-5)
    np.testing.assert_allclose(trace[15], GOLDEN_10_TRACE[15], rtol=1e-4)
    for k, ref in GOLDEN_10_TRACE.items():
        if k > 15:
            assert abs(np.log10(trace[k]) - np.log10(ref)) < 0.05 * abs(np.log10(ref)) + 1.0


@pytest.mark.parametrize("dtype,case,want", [
    ("float64", "banded", "dia"),
    ("float64", "permuted", "ell+rcm"),
    ("float32", "banded", "dia"),
    ("float32", "permuted", "ell+rcm"),
])
def test_file_trajectory_matches_jax(tmp_path, dtype, case, want):
    path = _write(tmp_path / "m.txt", (9, 8, 7), dtype, None if case == "banded" else 11)
    prob, perm, report = tio.read_hpc_row_structured(path, dtype=getattr(torch, dtype), device="cpu")
    assert report.format == want
    # allow_gell=False: the TPU gather tiers would run in interpret mode here
    jprob, jperm, _ = jio.read_hpc_row_structured(path, dtype=getattr(jnp, dtype), allow_gell=False)
    res = make_cg(prob.A, max_iter=60, tolerance=0.0)(prob.b, prob.x0)
    jres = jmake_cg(jprob.A, max_iter=60, tolerance=0.0)(jprob.b, jprob.x0)
    tr, jtr = res.trace.numpy(), np.asarray(jres.trace)
    rtol, floor = TRACE[dtype]
    if dtype == "float64":
        assert int(res.niters) == int(jres.niters) == 59
    n = min(int(res.niters), int(jres.niters)) + 1
    head = jtr[:n] > floor * jtr[0]
    assert head.sum() > 5
    np.testing.assert_allclose(tr[:n][head], jtr[:n][head], rtol=rtol)
    x, jx = tio.unpermute(res.x, perm), jio.unpermute(jres.x, jperm)
    assert np.max(np.abs(x - jx)) <= X_RTOL[dtype] * np.max(np.abs(jx))


def test_golden_file_through_the_cli_on_dia(tmp_path):
    """The reference's 10^3 f64 run from a file: DIA, 149 iterations, the
    golden trace in the residual lines (printed every 15 iterations)."""
    path = _write(tmp_path / "g10.txt", (10, 10, 10))
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        assert main([path, "--json", "--device", "cpu", "--skip-kernel-bench", "--check"]) == 0
    assert "# matrix structure: dia — banded as loaded: 27 diagonals" in err.getvalue()
    text = out.getvalue()
    trace = {0: float(text.split("Initial Residual = ")[1].split()[0])}
    for line in text.splitlines():
        if line.startswith("Iteration = "):
            parts = line.split()
            trace[int(parts[2])] = float(parts[5])
    report = json.loads(text[text.index("{"):])
    assert report["Dimensions"]["nx"] == report["Dimensions"]["ny"] == report["Dimensions"]["nz"] == 0
    assert report["Difference between computed and exact"] < 1e-12
    _golden_checks(trace, report["Number of iterations"])
    assert set(GOLDEN_10_TRACE) <= set(trace)


@pytest.mark.parametrize("backend", ["ell", "auto", "stencil"])
def test_golden_make_cg_on_generate_ell(backend):
    prob = generate_ell(ProblemConfig(10, 10, 10), "cpu")
    res = make_cg(prob.A, max_iter=150, tolerance=0.0, backend=backend)(prob.b, prob.x0)
    _golden_checks(res.trace.numpy(), int(res.niters))
    res = make_cg(prob.A.to_dia(), max_iter=150, tolerance=0.0, backend=backend)(prob.b, prob.x0)
    _golden_checks(res.trace.numpy(), int(res.niters))


@pytest.mark.parametrize("case,extra", [("banded", []), ("permuted", []), ("permuted", ["--no-reorder"])])
def test_cli_matches_jax_cli(tmp_path, case, extra):
    path = _write(tmp_path / "c.txt", (8, 7, 6), permute_seed=None if case == "banded" else 12)
    args = [path, "--json", "--skip-kernel-bench", "--max-iter", "10", *extra]
    rc, out = 0, io.StringIO()
    with redirect_stdout(out), redirect_stderr(io.StringIO()):
        rc = main(args + ["--device", "cpu"])
    assert rc == 0
    jout = io.StringIO()
    with redirect_stdout(jout), redirect_stderr(io.StringIO()):
        assert jax_main(args) == 0
    rep, jrep = (json.loads(o.getvalue()[o.getvalue().index("{"):]) for o in (out, jout))
    assert rep["Number of iterations"] == jrep["Number of iterations"] == 9
    np.testing.assert_allclose(rep["Final residual"], jrep["Final residual"], rtol=1e-10)
    assert rep["FLOPS Summary"] == jrep["FLOPS Summary"]


def test_cli_kernel_bench_and_structure_line(tmp_path, capsys):
    path = _write(tmp_path / "k.txt", (6, 5, 4), "float32", permute_seed=13)
    assert main([path, "--device", "cpu", "--dtype", "float32", "--json", "--quiet", "--max-iter", "10",
                 "--validate"]) == 0
    captured = capsys.readouterr()
    assert "# matrix structure: ell+rcm — RCM reduced bandwidth" in captured.err
    assert "# problem validated" in captured.err
    ts = json.loads(captured.out[captured.out.index("{"):])["Time Summary"]
    assert ts["SPARSEMV"] >= 0 and ts["WAXPBY  "] >= 0
    note = next(k for k in ts if k.startswith("("))
    assert "K11/K12 ELL gather kernel" in note and "native(EllMatrix)" in note


def test_make_cg_explicit_backends_and_refusals():
    prob = generate_ell(ProblemConfig(5, 4, 3), "cpu")
    with pytest.warns(UserWarning, match="stencil operators only"):
        res = make_cg(prob.A, max_iter=10, backend="megakernel")(prob.b, prob.x0)
    ref = make_cg(prob.A, max_iter=10)(prob.b, prob.x0)
    assert torch.equal(res.trace, ref.trace)
    with pytest.raises(ValueError, match="unknown backend"):
        make_cg(prob.A, backend="nonsense")
    shard = generate_ell(ProblemConfig(5, 4, 3), "cpu", rank=1, size=2)
    with pytest.raises(ValueError, match="row shard"):
        make_cg(shard.A)
    bf16 = generate_ell(ProblemConfig(5, 4, 3, dtype=torch.bfloat16), "cpu")
    for A in (bf16.A, bf16.A.to_dia()):  # plain on the CPU: K9/K11 have no bf16 instance
        assert int(make_cg(A, max_iter=8)(bf16.b, bf16.x0).niters) == 7
    assert isinstance(prob.A.to_dia(), DiaMatrix) and isinstance(prob.A, EllMatrix)
