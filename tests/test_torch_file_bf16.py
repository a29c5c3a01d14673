"""bfloat16 file mode of the port against the JAX package's, on the CPU:
the readers, the structure chooser, the plain K9/K11 bf16 matvecs, the
single-device solve, the distributed file tiers and the CLI.

The JAX package reads bf16 HPC-row files and solves them with its XLA
DIA/ELL matvecs in bf16 (its K9 is float32 only, and its chooser builds no
K11 gather matrix for 2-byte values). The port solves them on K9/K11's bf16
instances: bf16 storage, float32 sums, y rounded once; the tiers keep the
cg scalars in float32. On the CPU a single-device solve runs the all-bf16
plain recurrence, the JAX package's; the distributed tiers run the
kernels' plain versions with float32 scalars.

Tolerances are JAX's own for bf16 (tests/test_torch_bf16_kernels.py):
niters equal, the trace within rtol 0.15 where it is above 0.05 *
trace[0], max|x_port - x_jax| <= 0.08 (x solves to ones). The reader and
the matvecs move or sum the same values and are held bit for bit, as
measured below.
"""

import dataclasses
import io
import json
import os
import re
import subprocess
import sys
from contextlib import redirect_stderr, redirect_stdout

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import hpccg_tpu.io as jio  # noqa: E402
from hpccg_tpu import native  # noqa: E402
from hpccg_tpu.parallel import make_distributed_dia_cg as jmake_dia  # noqa: E402
from hpccg_tpu.parallel import make_distributed_ell_cg as jmake_ell  # noqa: E402
from hpccg_tpu.parallel import make_mesh as jmake_mesh  # noqa: E402
from hpccg_tpu.parallel.cg import shard_problem as jshard_problem  # noqa: E402
from hpccg_tpu.solver import make_cg as jmake_cg  # noqa: E402
from hpccg_tpu_torch import ProblemConfig, make_cg  # noqa: E402
from hpccg_tpu_torch import io as tio  # noqa: E402
from hpccg_tpu_torch.cli import main  # noqa: E402
from hpccg_tpu_torch.convert import explicit_problem_from_numpy, explicit_problem_to_numpy  # noqa: E402
from hpccg_tpu_torch.models.stencil import generate_ell  # noqa: E402
from hpccg_tpu_torch.operators import DiaMatrix, EllMatrix  # noqa: E402
from hpccg_tpu_torch.ops.cuda import dia as cdia  # noqa: E402
from hpccg_tpu_torch.ops.cuda import ell as cell  # noqa: E402
from hpccg_tpu_torch.parallel import cg as pcg  # noqa: E402
from hpccg_tpu_torch.parallel import make_mesh  # noqa: E402
from hpccg_tpu_torch.reorder import permute_ell  # noqa: E402

BF16 = torch.bfloat16
TRACE_RTOL, TRACE_FLOOR, X_ATOL = 0.15, 0.05, 0.08
# a grid where both packages' bf16 solves stagnate and run to max_iter 60
# (a smaller one lets JAX's bf16 DIA solve flush r.r to 0 at 57)
SOLVE_DIMS, SOLVE_ITERS = (12, 10, 8), 60


def _bits(a):
    """The bf16 bits of a torch tensor or an ml_dtypes / JAX array."""
    if torch.is_tensor(a):
        return a.contiguous().view(torch.int16).numpy()
    return np.asarray(a).view(np.int16)


def _write(path, dims, permute_seed=None, perturb=False, stored_zero=False):
    """A generate_ell stencil file (float64 values), its rows permuted, its
    diagonal perturbed by 1e-3 * row (values not exact in bf16), or one
    off-diagonal entry stored as 0 (which keeps it ELL)."""
    prob = generate_ell(ProblemConfig(*dims), "cpu")
    A = prob.A
    if stored_zero:  # A[r, c] = A[c, r] = 0 for an interior row r and its first neighbour c: still SPD
        vals = A.vals.clone()
        r = dims[0] * dims[1] + dims[0] + 1
        c = int(A.cols[r, 0])
        vals[r, 0] = 0.0
        vals[c, int(torch.nonzero((A.cols[c] == r) & A.valid)[0, 0])] = 0.0
        A = dataclasses.replace(A, vals=vals)
        prob = dataclasses.replace(prob, A=A, b=A.matvec(prob.xexact))
    if perturb:
        diag = (A.cols == torch.arange(A.local_nrow)[:, None]) & A.valid
        vals = A.vals.clone()
        vals[diag] += 1e-3 * torch.arange(A.local_nrow, dtype=torch.float64)
        A = dataclasses.replace(A, vals=vals)
        prob = dataclasses.replace(prob, A=A, b=A.matvec(prob.xexact))
    if permute_seed is not None:
        perm = np.random.default_rng(permute_seed).permutation(prob.total_nrow)
        index = torch.from_numpy(perm)
        prob = dataclasses.replace(prob, A=permute_ell(prob.A, perm), b=prob.b[index], xexact=prob.xexact[index])
    tio.write_hpc_row(str(path), prob)
    return str(path)


# ------------------------------------------------------------------ reader


def test_bf16_reader_matches_jax_bit_for_bit(tmp_path):
    """Values not exact in bf16 (a perturbed diagonal; b = A 1 from it) and
    three values at or next to a bf16 rounding midpoint, where a direct
    f64 -> bf16 rounding and one through float32 differ: both readers parse
    float64 and round through float32 (ml_dtypes in JAX, torch here), and
    agree bit for bit in the matrix, b, x0 and xexact, as read and as the
    structured reader's DIA."""
    path = _write(tmp_path / "p.txt", (6, 5, 4), perturb=True)
    prob, _ = tio.read_hpc_row(path, dtype=torch.float64, to_dia=False, device="cpu")
    mid = torch.tensor([1 + 2.0**-8 + 2.0**-40, 1 + 2.0**-8 - 2.0**-40, 3 + 3 * 2.0**-7 + 2.0**-35],
                       dtype=torch.float64)
    b = prob.b.clone()
    b[:3] = mid
    tio.write_hpc_row(path, dataclasses.replace(prob, b=b), x=mid.repeat(prob.total_nrow // 3 + 1)[:prob.total_nrow])
    direct = [float(np.float64(v).astype(np.float32)) for v in mid.tolist()]
    assert mid.to(BF16).tolist() == torch.tensor(direct).to(BF16).tolist()  # torch rounds through float32
    port, px = tio.read_hpc_row(path, dtype=BF16, to_dia=False, device="cpu")
    jprob, jx = jio.read_hpc_row(path, dtype=jnp.bfloat16, to_dia=False, device=False)
    assert port.A.vals.dtype == BF16 and np.asarray(jprob.A.vals).dtype.name == "bfloat16"
    assert np.array_equal(_bits(port.A.vals), _bits(jprob.A.vals))
    assert np.array_equal(port.A.cols.numpy(), np.asarray(jprob.A.cols))
    assert np.array_equal(port.A.valid.numpy(), np.asarray(jprob.A.valid))
    for got, want in ((port.b, jprob.b), (px, jx), (port.xexact, jprob.xexact)):
        assert np.array_equal(_bits(got), _bits(want))
    assert not torch.equal(port.A.vals.double(), prob.A.vals)  # the perturbation is not exact in bf16
    sprob, perm, report = tio.read_hpc_row_structured(path, dtype=BF16, device="cpu")
    jsprob, jperm, jreport = jio.read_hpc_row_structured(path, dtype=jnp.bfloat16)
    assert report.format == jreport.format == "dia" and perm is None and jperm is None
    assert sprob.A.offsets == jsprob.A.offsets
    assert np.array_equal(_bits(sprob.A.data), _bits(jsprob.A.data))


# ----------------------------------------------------------------- chooser

# (case, dims, permutation seed, reorder, JAX's bf16 format, the port's).
# Where they differ the Hopper byte rule decides on purpose: DIA streams
# ndiag * s bytes per row, ELL width * (s + 4), s = 2 in bf16.
# - permuted 8^3: JAX picks its strip-stack gather tier ("gstack", K13's
#   class, as loaded: a gather that the TPU builds in strips); the port's
#   gather is K11 (which covers K13's class) in the RCM basis, as its f32
#   choice: RCM cuts the band 503 -> 169, and DIA there would stream more
#   bytes than ELL's 27 * 6 per row;
# - permuted 6x6x5: JAX's slot-rate model takes DIA after RCM (141
#   diagonals at 7.6x inflation); the port's byte rule keeps ELL: 141 * 2 =
#   282 bytes per row against ELL's 27 * 6 = 162 (in f32 564 against 216).
CHOOSER = [
    ("banded", (7, 6, 5), None, True, "dia", "dia"),
    ("permuted, reorder off: banded as loaded", (7, 6, 5), 7, False, "dia", "dia"),
    ("permuted, reorder off: not banded", (10, 10, 10), 7, False, "ell", "ell"),
    ("permuted 8^3", (8, 8, 8), 6, True, "gstack", "ell+rcm"),
    ("permuted 6x6x5", (6, 6, 5), 8, True, "dia+rcm", "ell+rcm"),
]


@pytest.mark.parametrize("case,dims,seed,reorder,jwant,want", CHOOSER, ids=[c[0] for c in CHOOSER])
def test_bf16_chooser_against_jax(tmp_path, monkeypatch, case, dims, seed, reorder, jwant, want):
    monkeypatch.setattr(native, "rcm", lambda *args: None)  # JAX's RCM through scipy, as the port's
    path = _write(tmp_path / "m.txt", dims, seed)
    _, jperm, jreport = jio.read_hpc_row_structured(path, dtype=jnp.bfloat16, reorder=reorder)
    prob, perm, report = tio.read_hpc_row_structured(path, dtype=BF16, reorder=reorder, device="cpu")
    _, _, f32 = tio.read_hpc_row_structured(path, dtype=torch.float32, reorder=reorder, device="cpu")
    assert jreport.format == jwant and report.format == want == f32.format
    assert prob.A.dtype == BF16 and isinstance(prob.A, DiaMatrix if want.startswith("dia") else EllMatrix)
    assert (perm is None) == (not want.endswith("+rcm"))
    if jwant == want:
        assert (jperm is None) == (perm is None)
    else:
        assert "B per SpMV against ELL's" in report.reason


def test_pad_and_convert_keep_bf16():
    """pad_problem_rows keeps bf16 (identity pad rows, zero vectors);
    explicit problems convert both ways in bf16, sharded too."""
    prob = generate_ell(ProblemConfig(5, 4, 3, dtype=BF16), "cpu")
    for A in (prob.A, prob.A.to_dia()):
        padded = tio.pad_problem_rows(dataclasses.replace(prob, A=A), 7)
        assert padded.A.dtype == padded.b.dtype == BF16 and padded.total_nrow == 63
        y = padded.A.matvec(torch.ones(63, dtype=BF16))
        assert torch.equal(y[60:], torch.ones(3, dtype=BF16))
        arrays = explicit_problem_to_numpy(padded)
        mesh = make_mesh(3, devices=["cpu"] * 3)
        back = explicit_problem_from_numpy(arrays["A"], arrays["b"], arrays["x0"], arrays["xexact"], device="cpu",
                                           mesh=mesh)
        assert back.A[0].dtype == back.b[0].dtype == BF16
        again = explicit_problem_to_numpy(back)
        for key in ("b", "x0", "xexact"):
            assert np.array_equal(again[key].view(np.int16), arrays[key].view(np.int16))
        name = "data" if "data" in arrays["A"] else "vals"
        assert np.array_equal(again["A"][name].view(np.int16), arrays["A"][name].view(np.int16))


# ------------------------------------------------------------ the matvecs


def test_plain_bf16_matvecs_against_jax(tmp_path):
    """On the perturbed matrix: the plain K9/bf16 and K11/bf16 (f32 sums, y
    rounded once) agree bit for bit with each other and with JAX's
    EllMatrix.matvec in bf16 (XLA sums the bf16 products in f32 and rounds
    once), and lie within half a bf16 ulp of max|y| of the exact product;
    JAX's DiaMatrix.matvec (one bf16 multiply-add per diagonal) equals the
    port's DiaMatrix.matvec, the all-bf16 plain path, bit for bit (measured
    8.0e-3 of max|y| from the exact product)."""
    path = _write(tmp_path / "p.txt", (9, 8, 7), perturb=True)
    port, _ = tio.read_hpc_row(path, dtype=BF16, to_dia=False, device="cpu")
    jprob, _ = jio.read_hpc_row(path, dtype=jnp.bfloat16, to_dia=False)
    D, jD = port.A.to_dia(), jprob.A.to_dia()
    n = port.total_nrow
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(n)).to(BF16)
    jx = jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
    before = (cdia.spmv_dia.launches_bf16, cell.spmv_ell.launches_bf16)
    y9 = cdia.spmv_dia(cdia.prepare_dia(D), x)
    y11 = cell.spmv_ell(cell.prepare_ell(port.A), x)
    assert (cdia.spmv_dia.launches_bf16, cell.spmv_ell.launches_bf16) == before  # plain on the CPU
    assert y9.dtype == y11.dtype == BF16
    assert np.array_equal(_bits(y9), _bits(y11))
    assert np.array_equal(_bits(y11), _bits(jprob.A.matvec(jx)))
    assert np.array_equal(_bits(D.matvec(x)), _bits(jD.matvec(jx)))
    exact = D.to_dense().double() @ x.double()
    scale = float(exact.abs().max())
    assert float((y9.double() - exact).abs().max()) <= 2.0 ** -8 * scale
    # the window instance (dia-halo) on each rank's extended vector: the single-device product
    mesh = make_mesh(3, devices=["cpu"] * 3)
    blocks = pcg.shard_matrix(D, mesh)
    tier = pcg.HaloTier(blocks, mesh.devices, "dia-halo")
    assert all(ext.dtype == BF16 for ext in tier.strips.ext)
    assert np.array_equal(_bits(torch.cat(tier(mesh.shard(x)))), _bits(y9))


# ------------------------------------------------------------------ solves


def _jax_held(res, jres, x=None, jx=None):
    jt = np.asarray(jres.trace).astype(np.float64)
    head = np.isfinite(jt) & (jt > TRACE_FLOOR * jt[0])
    assert head[:5].all() and int(res.niters) == int(jres.niters) == SOLVE_ITERS - 1
    np.testing.assert_allclose(res.trace.double().numpy()[head], jt[head], rtol=TRACE_RTOL)
    x = res.x if x is None else x
    jx = jres.x if jx is None else jx
    assert np.abs(np.asarray(x, dtype=np.float64) - np.asarray(jx).astype(np.float64)).max() <= X_ATOL


@pytest.mark.parametrize("fmt", ["dia", "ell"])
def test_single_device_bf16_solve_matches_jax(tmp_path, fmt):
    path = _write(tmp_path / "s.txt", SOLVE_DIMS)
    prob, _ = tio.read_hpc_row(path, dtype=BF16, to_dia=fmt == "dia", device="cpu")
    jprob, _ = jio.read_hpc_row(path, dtype=jnp.bfloat16, to_dia=fmt == "dia")
    res = make_cg(prob.A, max_iter=SOLVE_ITERS, tolerance=0.0)(prob.b, prob.x0)
    jres = jmake_cg(jprob.A, max_iter=SOLVE_ITERS, tolerance=0.0)(jprob.b, jprob.x0)
    assert res.x.dtype == BF16
    _jax_held(res, jres, res.x.float().numpy())


TIERS = {"dia-halo": (pcg.make_distributed_dia_cg, True, jmake_dia),
         "ell-halo": (pcg.make_distributed_ell_halo_cg, False, jmake_ell),
         "ell-allgather": (pcg.make_distributed_ell_cg, False, jmake_ell)}


@pytest.mark.parametrize("tier", list(TIERS))
def test_bf16_tier_matches_jax(tmp_path, tier):
    """Each file tier on 4 CPU ranks in bf16 (the kernels' plain versions:
    K9/K11 bf16 on bf16 strips and vectors, float32 cg scalars) against the
    JAX package's distributed solve of the same bf16 file (XLA matvecs in
    bf16, bf16 scalars)."""
    make, to_dia, jmake = TIERS[tier]
    path = _write(tmp_path / "t.txt", SOLVE_DIMS)
    prob, _ = tio.read_hpc_row(path, dtype=BF16, to_dia=to_dia, device="cpu")
    jprob, _ = jio.read_hpc_row(path, dtype=jnp.bfloat16, to_dia=to_dia)
    jmesh = jmake_mesh(4)
    jA = jprob.A if to_dia else jshard_problem(jprob, jmesh).A
    jres = jmake(jmesh, max_iter=SOLVE_ITERS)(jA, jprob.b, jprob.x0)
    mesh = make_mesh(4, devices=["cpu"] * 4)
    sp = pcg.shard_problem(prob, mesh)
    res = make(mesh, max_iter=SOLVE_ITERS)(sp.A, sp.b, sp.x0)
    assert res.x[0].dtype == BF16 and res.trace.dtype == torch.float32
    _jax_held(res, jres, torch.cat(res.x).float().numpy(), np.asarray(jres.x))


# --------------------------------------------------------------------- CLI


def _port_cli(args):
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        assert main(args + ["--device", "cpu"]) == 0
    text = out.getvalue()
    return json.loads(text[text.index("{"):]), err.getvalue()


def _label(rep):
    note = next(k for k in rep["Time Summary"] if k.startswith("("))
    return re.search(r"backend=([\w:-]+(\(\w+\))?)", note).group(1)


def _structure(err):
    return next(line for line in err.splitlines() if line.startswith("# matrix structure: "))


@pytest.mark.parametrize("mesh", ["1", "4"])
def test_cli_bf16_file_matches_jax_cli(tmp_path, mesh):
    """``FILE --dtype bfloat16`` through both CLIs, the JAX one in a
    subprocess (its 8 virtual CPU devices): the same structure line,
    backend label (native(DiaMatrix), distributed:dia-halo) and
    iterations. --quiet: the JAX CLI cannot format its bf16 trace in the
    residual lines."""
    path = _write(tmp_path / "c.txt", SOLVE_DIMS)
    args = [path, "--dtype", "bfloat16", "--max-iter", str(SOLVE_ITERS), "--tolerance", "0", "--json", "--quiet",
            "--skip-kernel-bench", "--mesh", mesh]
    rep, err = _port_cli(args)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""),
               XLA_FLAGS=os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8")
    proc = subprocess.run([sys.executable, "-m", "hpccg_tpu", *args], capture_output=True, text=True, env=env,
                          cwd=str(tmp_path), timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    jrep = json.loads(proc.stdout[proc.stdout.index("{"):])
    assert _structure(err) == _structure(proc.stderr) == "# matrix structure: dia — banded as loaded: 27 diagonals"
    assert _label(rep) == _label(jrep) == ("native(DiaMatrix)" if mesh == "1" else "distributed:dia-halo")
    assert rep["Number of iterations"] == jrep["Number of iterations"] == SOLVE_ITERS - 1
    assert rep["Dimensions"]["dtype"] == "bfloat16"


def test_cli_bf16_tiers_follow_jax(tmp_path):
    """At --mesh 4 in bf16: --backend collective on the banded file falls
    back to dia-halo (K17 takes no bf16) with the reason; a file that stays
    ELL runs ell-allgather, as the JAX package's bf16 file mode does (its
    gather-window tier needs a gather matrix it never builds for bf16), and
    the kernel bench names the bf16 instance."""
    banded = _write(tmp_path / "b.txt", SOLVE_DIMS)
    base = ["--dtype", "bfloat16", "--max-iter", "20", "--json", "--quiet", "--mesh", "4", "--check"]
    rep, err = _port_cli([banded, *base, "--backend", "collective", "--skip-kernel-bench"])
    assert "collective unavailable: the collective DIA kernel takes float32 or float64" in err
    assert _label(rep) == "distributed:dia-halo" and rep["Difference between computed and exact"] < 0.1
    ell = _write(tmp_path / "e.txt", SOLVE_DIMS, stored_zero=True)  # band 121 fits the 240-row shards
    rep, err = _port_cli([ell, *base])
    assert "# matrix structure: ell — matrix stores explicit zero entries" in err
    assert "bfloat16: the ELL halo tier stands for the JAX package's gather-window tier" in err
    assert _label(rep) == "distributed:ell-allgather" and rep["Number of iterations"] == 19
    assert rep["Difference between computed and exact"] < 0.1 and rep["Time Summary"]["SPARSEMV"] >= 0
    rep, _ = _port_cli([banded, "--dtype", "bfloat16", "--max-iter", "8", "--json", "--quiet"])
    assert "DIA kernel (bf16 instance)" in next(k for k in rep["Time Summary"] if k.startswith("("))
