"""The shape of a run's last line, and the runs that must print none."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from hpcbench import run
from hpcbench.run import print_checks, run_cell, used_cards

from conftest import mesh_cell, mesh_system

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
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes", "memory_peak_bytes_per_card"}
    assert line["device"]["count"] == 1
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


def test_used_cards_are_those_whose_memory_rose_or_that_ran_kernels():
    cards, base = [0, 1, 2, 3], {0: 500, 1: 0, 2: 0, 3: 0}
    assert used_cards(cards, base, {0: 900, 1: 10, 2: 0, 3: 0}) == [0, 1]
    assert used_cards(cards, base, {0: 500, 1: 10, 2: 0, 3: 0}, ran=[0, 3]) == [0, 1, 3]
    assert used_cards([0], {0: 500}, {0: 500}) == []


class StubCards(run.Cards):
    """Four cards whose allocation rises where the stub runner touched them."""

    touched = set()

    def __init__(self, devices):
        self.cards, self.base = [0, 1, 2, 3], {}

    def reset(self):
        self.base = {i: 1000 for i in self.cards}

    def peaks(self):
        return {i: 1000 + 4096 * (i in self.touched) for i in self.cards}


@pytest.mark.parametrize("touched, rc", [((0, 1), 1), ((0, 1, 2, 3), 0)])
def test_a_run_that_leaves_cards_unused_exits_1(bench, monkeypatch, capsys, touched, rc):
    """A four-chip cell whose stub runner touches fewer cards than the cell
    asks for: no result line, exit code 1, the unused cards named; one
    that touches all four reports a measured count of 4."""
    bench, cell = mesh_cell(bench, 4)
    StubCards.touched = set()

    def stub(config, problem, devices, spans):
        runner = mesh_system()(config, problem, devices, spans)
        solve = runner.solve_fn

        def touching(b, x0):
            StubCards.touched.update(touched)
            return solve(b, x0)

        runner.solve_fn = touching
        return runner

    real = run.run_cell
    monkeypatch.setattr(run, "Cards", StubCards)
    monkeypatch.setattr(run, "run_cell", lambda *a, **k: real(*a, device="cpu", system=stub, **k))
    monkeypatch.setattr(run, "Bench", lambda: bench)
    monkeypatch.setattr(run, "forbidden_modules", lambda: [])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert run.main(["--workload", cell, "--seed", "5", "--seconds", "0.2", "--trace", "0"]) == rc
    out, err = capsys.readouterr()
    if rc:
        assert out == "" and "cuda:2, cuda:3" in err and "used 2" in err
    else:
        line = json.loads(out.strip().splitlines()[-1])
        assert line["correct"] and line["device"]["count"] == 4
        assert line["device"]["memory_peak_bytes_per_card"] == [1000 + 4096] * 4
