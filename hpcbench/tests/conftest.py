"""Fixtures of the benchmark's CPU tests: the real BENCHMARK.json's cells
cut to tiny grids in a temporary folder, so that a whole run (inputs,
set-up, window, reference, comparison) takes a second on the CPU; and a
cell of several chips added to them as files and entries only, with a
builder that solves the z-stacked problem on a mesh of the cell's
devices."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from hpcbench.registry import Bench  # noqa: E402
from hpcbench.systems import Runner  # noqa: E402

GRID = 10
# at a tiny grid the recurrence converges past 1e-30 in 150 iterations, and
# below ~1e-14 of the initial residual follows each run's rounding: the
# tiny cells run 20 iterations (normr near 1e-10 of the initial residual)
# and compare the trace down to 1e-12 of it
TINY_LIMITS = {"head": 1e-12, "limits": {"niters": 0, "trace_rel": 1e-10, "normr_rel": 1e-10, "x_rel": 1e-10}}


def tiny_bench(tmp: Path, grid: int = GRID, max_iter: int = 20) -> Bench:
    """The real cells with their grids cut to ``grid``^3, ``max_iter``
    iterations (the tail past ``TINY_LIMITS``' head stays short) and one
    cell per ordering."""
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    base = tmp / "hpcbench"
    shutil.copytree(ROOT / "hpcbench" / "metrics", base / "metrics")
    shutil.copy(ROOT / "hpcbench" / "peaks.json", base / "peaks.json")
    for sub in ("traffic", "checks", "configs"):
        (base / sub).mkdir(parents=True, exist_ok=True)
    for entry in spec["configs"]:
        config = json.loads((ROOT / entry["file"]).read_text())
        config["max_iter"] = max_iter
        if config.get("rows") is not None:
            config["rows"] = grid ** 3
        entry["file"] = f"hpcbench/configs/{entry['name']}.json"
        (tmp / entry["file"]).write_text(json.dumps(config))
    for cell in spec["workloads"]:
        traffic = json.loads((ROOT / "hpcbench" / "traffic" / f"{cell['traffic']}.json").read_text())
        traffic.update(grid=[grid] * 3, trace_solves=2)
        (base / "traffic" / f"{cell['traffic']}.json").write_text(json.dumps(traffic))
        (base / "checks" / f"{cell['name']}.json").write_text(json.dumps(TINY_LIMITS))
    (tmp / "BENCHMARK.json").write_text(json.dumps(spec))
    return Bench(root=tmp, base=base)


@pytest.fixture
def bench(tmp_path) -> Bench:
    return tiny_bench(tmp_path)


def mesh_cell(bench: Bench, chips: int, grid=(6, 5, 8), max_iter: int = 20) -> tuple:
    """A cell of ``chips`` chips added to ``bench`` as files and entries
    only: a configuration, a traffic mix on the global ``grid`` (z split
    over the ranks), a limits file, and its entry in ``workloads``.
    Returns (the bench with the cell, the cell's name)."""
    base, name = bench.base, f"stencil27_f64_mesh{chips}"
    config = json.loads((bench.root / "hpcbench/configs/stencil27_f64.json").read_text())
    config.update(name=name, max_iter=max_iter)
    (base / "configs" / f"{name}.json").write_text(json.dumps(config))
    traffic = json.loads((base / "traffic" / "ref300.json").read_text())
    traffic.update(grid=list(grid), rhs=2, x_samples=2)
    (base / "traffic" / f"zstack{chips}.json").write_text(json.dumps(traffic))
    cell = f"{name}.zstack{chips}"
    (base / "checks" / f"{cell}.json").write_text(json.dumps(TINY_LIMITS))
    spec = json.loads(json.dumps(bench.spec))
    spec["configs"].append({"name": name, "source": "x", "reduced": ["max_iter"], "why": "x",
                            "file": f"hpcbench/configs/{name}.json"})
    spec["workloads"].append({"name": cell, "config": name, "traffic": f"zstack{chips}", "chips": chips,
                              "why": "x"})
    return Bench(root=bench.root, spec=spec, base=base), cell


def mesh_system(backend: str = "stencil"):
    """A builder of the z-stacked problem on a mesh of the cell's devices,
    one rank each: ``make_distributed_cg`` on the global grid cut into
    equal z blocks, b and x0 sharded in set-up, x unsharded for the
    sample after the window."""

    def setup(config, problem, devices, spans):
        from hpccg_tpu_torch.config import ProblemConfig
        from hpccg_tpu_torch.parallel.cg import make_distributed_cg
        from hpccg_tpu_torch.parallel.mesh import make_mesh

        mesh = make_mesh(devices=devices)
        nx, ny, nz = problem.grid
        local = ProblemConfig(nx, ny, nz // mesh.size, config["stencil"], problem.dtype)
        solve = make_distributed_cg(local, mesh, max_iter=config["max_iter"], tolerance=config["tolerance"],
                                    backend=backend)
        return Runner(solve, [mesh.shard(b) for b in problem.rhs], mesh.shard(problem.x0),
                      notes={"ranks": mesh.size, "backend": backend}, unshard=mesh.unshard)

    return setup
