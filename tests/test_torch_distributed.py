"""The port's distributed stencil path (``hpccg_tpu_torch.parallel``) against
the JAX package's (``hpccg_tpu.parallel``), on the CPU.

The port's mesh is single-controller, as JAX's is: ``devices=["cpu"] * n``
gives n ranks in one process, the counterpart of the 8 virtual CPU devices
of ``tests/conftest.py``. Both sides solve the very same global system:
``generate_problem_sharded`` builds it bit for bit on each side.

On the CPU the port's kernel backends run their kernels' plain versions, so
JAX's shard_map tier on the XLA stencil (``backend="stencil"``, fast) is the
reference for every backend and method; JAX's Pallas tier runs in interpret
mode for one backend at ndev 2.

Tolerances, and why (float64 at 6x5x4 per rank, max_iter 40):

- cg, cg1: niters equal, trace rtol 1e-10 above 1e-11 * trace[0] (the same
  recurrence; the partial sums run in another order); x rtol 1e-10.
- pipecg: trace rtol 1e-6 above 1e-9 * trace[0]: its w/z recurrences carry
  each run's rounding forward (tests/test_torch_methods.py); x rtol 1e-8.
"""

import functools
import json
import os
import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import hpccg_tpu  # noqa: E402
from hpccg_tpu.parallel import make_mesh as jmake_mesh  # noqa: E402
from hpccg_tpu.parallel.cg import generate_problem_sharded as jgenerate_sharded  # noqa: E402
from hpccg_tpu.parallel.cg import make_distributed_cg as jmake_distributed_cg  # noqa: E402
from hpccg_tpu_torch import ProblemConfig  # noqa: E402
from hpccg_tpu_torch.cli import main  # noqa: E402
from hpccg_tpu_torch.convert import result_from_numpy, result_to_numpy, shards_from_numpy, shards_to_numpy  # noqa: E402
from hpccg_tpu_torch.parallel import generate_problem_sharded, make_distributed_cg, make_mesh  # noqa: E402
from hpccg_tpu_torch.parallel.cg import resolve_distributed_backend  # noqa: E402
from hpccg_tpu_torch.parallel.halo import HaloPlanes, exchange_halo, stencil_matvec_halo  # noqa: E402

from oracle import GOLDEN_10_NITERS, GOLDEN_10_TRACE  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
NDEVS = [1, 2, 4, 6, 8]
BACKENDS = ["stencil", "pallas", "pallas_dd", "pallas_v1", "pallas_fused", "collective"]
METHODS = ["cg", "cg1", "pipecg"]
LOCAL = (6, 5, 4)
TOL = {"cg": (1e-10, 1e-11, 1e-10), "cg1": (1e-10, 1e-11, 1e-10), "pipecg": (1e-6, 1e-9, 1e-8)}


def _cpu_mesh(ndev):
    return make_mesh(ndev, devices=["cpu"] * ndev)


@functools.cache
def _jax_reference(ndev, method, stencil=27):
    """JAX's shard_map solve on the XLA stencil: (x, trace, niters)."""
    cfg = hpccg_tpu.ProblemConfig(*LOCAL, stencil=stencil)
    mesh = jmake_mesh(ndev)
    prob = jgenerate_sharded(cfg, mesh)
    res = jmake_distributed_cg(cfg, mesh, max_iter=40, backend="stencil", method=method)(prob.b, prob.x0)
    return np.asarray(res.x), np.asarray(res.trace), int(res.niters)


def _held(res, ref, method):
    jx, jt, jn = ref
    rtol, floor, xtol = TOL[method]
    t = res.trace.numpy()
    head = np.isfinite(jt) & (jt > floor * jt[0])
    assert head[:10].all()
    assert int(res.niters) == jn
    np.testing.assert_allclose(t[head], jt[head], rtol=rtol)
    np.testing.assert_allclose(shards_to_numpy(res.x), jx, rtol=xtol)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("stencil", [27, 7])
def test_generate_problem_sharded_is_bitwise_jax(stencil, dtype):
    """b = A 1 on each rank with the halo'd matvec, on the 8-rank mesh: the
    same bits as JAX's on its 8 virtual devices."""
    import jax.numpy as jnp

    jprob = jgenerate_sharded(hpccg_tpu.ProblemConfig(*LOCAL, stencil=stencil, dtype=getattr(jnp, dtype)),
                              jmake_mesh(8))
    prob = generate_problem_sharded(ProblemConfig(*LOCAL, stencil=stencil, dtype=getattr(torch, dtype)),
                                    _cpu_mesh(8))
    for name in ("b", "x0", "xexact"):
        got, want = shards_to_numpy(getattr(prob, name)), np.asarray(getattr(jprob, name))
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    assert (prob.total_nrow, prob.total_nnz_model, prob.total_nnz_exact) == (
        jprob.total_nrow, jprob.total_nnz_model, jprob.total_nnz_exact)
    assert prob.A.nz == jprob.A.nz == 8 * LOCAL[2]


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("ndev", NDEVS)
def test_make_distributed_cg_matches_jax(ndev, method, backend):
    cfg = ProblemConfig(*LOCAL)
    mesh = _cpu_mesh(ndev)
    prob = generate_problem_sharded(cfg, mesh)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # pallas_fused with cg1/pipecg warns and runs pallas
        res = make_distributed_cg(cfg, mesh, max_iter=40, backend=backend, method=method)(prob.b, prob.x0)
    assert isinstance(res.x, tuple) and len(res.x) == ndev
    assert all(x.shape == (cfg.local_nrow,) for x in res.x)
    _held(res, _jax_reference(ndev, method), method)


@pytest.mark.parametrize("method", METHODS)
def test_seven_point_matches_jax(method):
    cfg = ProblemConfig(*LOCAL, stencil=7)
    mesh = _cpu_mesh(4)
    prob = generate_problem_sharded(cfg, mesh)
    res = make_distributed_cg(cfg, mesh, max_iter=40, backend="collective", method=method)(prob.b, prob.x0)
    jx, jt, jn = _jax_reference(4, method, 7)
    head = jt > TOL[method][1] * jt[0]
    np.testing.assert_allclose(res.trace.numpy()[head], jt[head], rtol=TOL[method][0])


@pytest.mark.parametrize("method", ["cg1", "pipecg"])
def test_replace_every_matches_jax(method):
    """Residual replacement on the sharded recurrences (every backend but
    collective), against JAX's shard_map tier with the same interval."""
    cfg = ProblemConfig(*LOCAL)
    mesh, jmesh = _cpu_mesh(4), jmake_mesh(4)
    jcfg = hpccg_tpu.ProblemConfig(*LOCAL)
    jprob = jgenerate_sharded(jcfg, jmesh)
    kw = dict(max_iter=40, method=method, replace_every=5)
    jres = jmake_distributed_cg(jcfg, jmesh, backend="stencil", **kw)(jprob.b, jprob.x0)
    prob = generate_problem_sharded(cfg, mesh)
    for backend in ("stencil", "pallas"):
        res = make_distributed_cg(cfg, mesh, backend=backend, **kw)(prob.b, prob.x0)
        _held(res, (np.asarray(jres.x), np.asarray(jres.trace), int(jres.niters)), "pipecg")


def test_pallas_fused_matches_jax_interpret():
    """JAX's own Pallas fused tier (K3/K4 in interpret mode, ppermuted halo
    planes) on two devices against the port's K3/K4 plain versions."""
    jcfg = hpccg_tpu.ProblemConfig(*LOCAL)
    jmesh = jmake_mesh(2)
    jprob = jgenerate_sharded(jcfg, jmesh)
    jres = jmake_distributed_cg(jcfg, jmesh, max_iter=25, backend="pallas_fused")(jprob.b, jprob.x0)
    cfg = ProblemConfig(*LOCAL)
    mesh = _cpu_mesh(2)
    prob = generate_problem_sharded(cfg, mesh)
    res = make_distributed_cg(cfg, mesh, max_iter=25, backend="pallas_fused")(prob.b, prob.x0)
    assert int(res.niters) == int(jres.niters) == 24
    jt = np.asarray(jres.trace)
    head = jt > 1e-11 * jt[0]
    np.testing.assert_allclose(res.trace.numpy()[head], jt[head], rtol=1e-10)


@pytest.mark.parametrize("backend", ["stencil", "collective"])
def test_golden_run_on_two_ranks(backend):
    """The global 10^3 problem as two 10x10x5 ranks: the reference's golden
    run, 149 iterations."""
    cfg = ProblemConfig(10, 10, 5)
    mesh = _cpu_mesh(2)
    prob = generate_problem_sharded(cfg, mesh)
    res = make_distributed_cg(cfg, mesh, max_iter=150, backend=backend, method="cg")(prob.b, prob.x0)
    trace = res.trace.numpy()
    assert int(res.niters) == GOLDEN_10_NITERS
    np.testing.assert_allclose(trace[0], GOLDEN_10_TRACE[0], rtol=1e-5)
    np.testing.assert_allclose(trace[15], GOLDEN_10_TRACE[15], rtol=1e-4)
    for k, ref in GOLDEN_10_TRACE.items():
        if k > 15:
            assert abs(np.log10(trace[k]) - np.log10(ref)) < 0.05 * abs(np.log10(ref)) + 1.0


def test_mesh_shards_and_halo():
    mesh = _cpu_mesh(3)
    v = torch.arange(3 * 24, dtype=torch.float64)
    parts = mesh.shard(v)
    assert len(parts) == 3 and all(p.shape == (24,) for p in parts)
    assert torch.equal(mesh.unshard(parts), v)
    with pytest.raises(ValueError):
        mesh.shard(v[:-1])
    grids = [p.view(2, 3, 4) for p in parts]
    halos = exchange_halo(grids)
    assert torch.equal(halos[0][0], torch.zeros(3, 4)) and torch.equal(halos[2][1], torch.zeros(3, 4))
    assert torch.equal(halos[1][0], grids[0][-1]) and torch.equal(halos[1][1], grids[2][0])
    op = ProblemConfig(4, 3, 2)
    from hpccg_tpu_torch.parallel.cg import local_operator

    A = local_operator(op)
    planes = HaloPlanes(A, mesh.devices, torch.float64)
    two = planes.planes2(parts)
    assert torch.equal(two[1][0], grids[0][-1]) and torch.equal(two[0][0], torch.zeros(3, 4))
    # the halo'd matvec of the shards is the global matvec
    from hpccg_tpu_torch.operators import StencilOperator

    whole = StencilOperator(4, 3, 6)
    got = torch.cat(stencil_matvec_halo(A, parts))
    assert torch.equal(got, whole.matvec(v))


def test_make_mesh_and_backend_resolution():
    with pytest.raises(ValueError, match="requested 3 devices"):
        make_mesh(3, devices=["cpu", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(ValueError):
            make_mesh(1)  # no CUDA devices: the default mesh takes CUDA devices only
    cfg32, cfg64, cfg16 = (ProblemConfig(*LOCAL, dtype=d) for d in (torch.float32, torch.float64, torch.bfloat16))
    assert resolve_distributed_backend(cfg32, "auto", "cpu") == "stencil"
    assert resolve_distributed_backend(cfg32, "auto", "cuda") == "pallas"
    assert resolve_distributed_backend(cfg64, "auto", "cuda") == "pallas_dd"
    assert resolve_distributed_backend(cfg16, "auto", "cuda") == "pallas"  # K2's bf16 instance, as JAX
    with pytest.raises(ValueError):
        resolve_distributed_backend(cfg32, "megakernel", "cpu")
    mesh = _cpu_mesh(2)
    with pytest.raises(ValueError, match="pallas_dd"):
        make_distributed_cg(cfg32, mesh, max_iter=5, backend="pallas_dd")
    with pytest.raises(ValueError, match="unknown CG method"):
        make_distributed_cg(cfg64, mesh, max_iter=5, method="bicg")


def test_convert_sharded_result_round_trips():
    cfg = hpccg_tpu.ProblemConfig(*LOCAL)
    jmesh = jmake_mesh(4)
    jprob = jgenerate_sharded(cfg, jmesh)
    jres = jmake_distributed_cg(cfg, jmesh, max_iter=10)(jprob.b, jprob.x0)
    mesh = _cpu_mesh(4)
    res = result_from_numpy(*(np.asarray(getattr(jres, k)) for k in ("x", "niters", "normr", "rtrans", "trace")),
                            device="cpu", mesh=mesh)
    assert isinstance(res.x, tuple) and len(res.x) == 4
    out = result_to_numpy(res)
    for name in ("x", "niters", "normr", "rtrans", "trace"):
        np.testing.assert_array_equal(out[name], np.asarray(getattr(jres, name)))
    parts = shards_from_numpy(np.asarray(jprob.b), mesh)
    np.testing.assert_array_equal(shards_to_numpy(parts), np.asarray(jprob.b))


def _jax_cli(args):
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8", JAX_PLATFORMS="cpu",
               PYTHONPATH=str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-m", "hpccg_tpu", *args], capture_output=True, text=True, env=env,
                          cwd=ROOT, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    return json.loads(proc.stdout[proc.stdout.index("{"):])


@pytest.mark.parametrize("extra,jax_extra", [
    (["--method", "cg1"], []),
    # JAX's collective kernels take ~45 s in interpret mode here: its
    # shard_map tier with the same method stands in (test_torch_collective.py
    # holds the two equal)
    (["--method", "pipecg", "--backend", "collective"], ["--method", "pipecg"]),
    (["--backend", "pallas_fused", "--method", "cg1", "--rr-every", "10"], []),
])
def test_mesh_cli_matches_jax_cli(extra, jax_extra, capsys):
    args = ["6", "5", "4", "--mesh", "4", "--json", "--skip-kernel-bench", "--max-iter", "40"]
    jrep = _jax_cli(args + (jax_extra or extra))
    args += extra
    assert main(args + ["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    rep = json.loads(out[out.index("{"):])
    assert rep["Number of iterations"] == jrep["Number of iterations"] == 39
    # 40 iterations reach ~1e-24 of trace[0]: below the floor, orders of magnitude
    assert abs(np.log10(rep["Final residual"]) - np.log10(jrep["Final residual"])) < 1.0
    assert rep["FLOPS Summary"] == jrep["FLOPS Summary"]
    assert rep["Parallelism"]["Number of mesh devices"] == jrep["Parallelism"]["Number of mesh devices"] == 4
    assert rep["Parallelism"]["Mesh axes"] == jrep["Parallelism"]["Mesh axes"] == "z"
    assert rep["Dimensions"]["global nz"] == jrep["Dimensions"]["global nz"] == 16


def test_mesh_cli_messages(capsys):
    """JAX's messages: collective needs --mesh > 1; the whole-solve names are
    not distributed backends; --refine is single-device; HxZ meshes are not
    ported. File mode at --mesh > 1 is (tests/test_torch_distributed_file.py):
    a missing file is refused as on one device."""
    base = ["6", "5", "4", "--device", "cpu", "--json", "--skip-kernel-bench", "--max-iter", "10", "--quiet"]
    assert main(base + ["--backend", "collective"]) == 0
    assert "--backend collective needs --mesh > 1" in capsys.readouterr().err
    assert main(base + ["--mesh", "2", "--backend", "streamkernel"]) == 0
    assert "is not a distributed solver backend" in capsys.readouterr().err
    assert main(base + ["--mesh", "2", "--refine", "2"]) == 0
    assert "--refine is a single-device path" in capsys.readouterr().err
    assert main(base + ["--mesh", "2x4"]) == 2
    assert "not yet ported" in capsys.readouterr().err
    assert main(["m.txt", "--device", "cpu", "--mesh", "2"]) == 2
    assert "error: cannot read m.txt" in capsys.readouterr().err
