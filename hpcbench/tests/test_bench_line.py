"""The shape of a run's last line, and the runs that must print none."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from hpcbench.run import print_checks, run_cell

ROOT = Path(__file__).resolve().parents[2]
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("trace", [False, True])
def test_result_line_shape(bench, trace, capsys):
    cell = "hpcrow27_f64.natural128"
    out = run_cell(bench, cell, 4_000_000_123, 0.2, trace, device="cpu")
    line = json.loads(json.dumps(out))
    keys = list(line)
    assert keys[: len(KEYS)] == KEYS and keys[-1] == "checks"
    assert ("breakdown" in keys) == trace
    assert isinstance(line["correct"], bool) and line["correct"]
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    expected = {m["name"] for m in bench.metrics(cell, trace)}
    if trace:  # on the CPU there is no device trace: only the host span is read
        assert set(line["metrics"]) == {"reorder.structure_s"} and {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert all(len(v) <= 10 for v in line["breakdown"].values())
    else:
        assert set(line["metrics"]) == expected
    for metric in line["metrics"].values():
        assert set(metric) == {"value", "unit"} and metric["value"] > 0
    for n in line["checks"].values():
        assert set(n) == {"value", "limit"} and n["value"] <= n["limit"]
    print_checks(line["checks"])
    err = capsys.readouterr().err.strip().splitlines()
    assert [e.split()[1] for e in err] == list(line["checks"])


def _run(args, cwd, env=None):
    return subprocess.run([sys.executable, "-m", "hpcbench.run", *args], cwd=cwd, capture_output=True, text=True,
                          env=env, timeout=120)


def test_without_a_gpu_it_fails_and_prints_no_result():
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    proc = _run(["--workload", "stencil27_f64.ref300", "--seed", "3", "--seconds", "1", "--trace", "0"], ROOT, env)
    assert proc.returncode != 0 and proc.stdout == ""
    assert "GPU" in proc.stderr


def test_alone_in_a_folder_it_fails_and_prints_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "hpcbench", tmp_path / "hpcbench", ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = _run(["--workload", "stencil27_f64.ref300", "--seed", "3", "--seconds", "1"], tmp_path, env)
    assert proc.returncode != 0 and proc.stdout == ""
