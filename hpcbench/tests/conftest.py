"""Fixtures of the benchmark's CPU tests: the real BENCHMARK.json's cells
cut to tiny grids in a temporary folder, so that a whole run (inputs,
set-up, window, reference, comparison) takes a second on the CPU."""

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
