"""Finding configurations, traffic mixes, limits and metric readers by
name, and a cell added as files and entries only."""

from __future__ import annotations

import json
import re
from pathlib import Path

import pytest

from hpcbench.registry import Bench
from hpcbench.run import run_cell

from conftest import mesh_cell, mesh_system

ROOT = Path(__file__).resolve().parents[2]

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_every_cell_finds_its_files():
    bench = Bench()
    for cell in bench.spec["workloads"]:
        config = bench.config(cell["config"])
        traffic = bench.traffic(cell["traffic"])
        limits = bench.limits(cell["name"])
        assert config["name"] == cell["config"] and traffic["name"] == cell["traffic"]
        assert set(limits["limits"]) == {"niters", "trace_rel", "normr_rel", "x_rel"}
        assert bench.metrics(cell["name"], False) and bench.metrics(cell["name"], True)
    for entry in bench.spec["end_to_end"] + bench.spec["per_layer"]:
        assert callable(bench.reader(entry["name"]))


def test_benchmark_json_keeps_to_its_contract():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    names = [e["name"] for key in ("configs", "workloads", "end_to_end", "per_layer") for e in spec[key]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    e2e = {m["name"] for m in spec["end_to_end"]}
    assert e2e == {"gnnz_per_s", "solve_ms_p95", "setup_s"}
    for m in spec["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    cells = {c["name"] for c in spec["workloads"]}
    for m in spec["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
        assert re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"])
    for c in spec["workloads"]:
        assert c["chips"] in (1, 4) and len(c["why"]) <= 200
        assert (ROOT / "hpcbench" / "traffic" / f"{c['traffic']}.json").is_file()
    four = sum(c["chips"] == 4 for c in spec["workloads"])
    assert four <= max(1, len(spec["workloads"]) // 4)
    for c in spec["configs"]:
        assert c["file"].startswith("hpcbench/") and len(c["source"]) <= 200


def test_a_cell_and_a_metric_added_as_files(bench, tmp_path):
    """A new configuration, traffic mix, limits file and per-layer metric,
    each a file of its own, with entries in BENCHMARK.json: the harness
    runs the new cell and reports the new metric without an edit."""
    base = bench.base
    config = json.loads((bench.root / "hpcbench/configs/stencil27_f64.json").read_text())
    config.update(name="stencil27_f64_short", max_iter=20)
    (base / "configs" / "stencil27_f64_short.json").write_text(json.dumps(config))
    traffic = json.loads((base / "traffic" / "ref300.json").read_text())
    traffic.update(grid=[8, 6, 5], rhs=2, x_samples=1)
    (base / "traffic" / "flat8.json").write_text(json.dumps(traffic))
    (base / "checks" / "stencil27_f64_short.flat8.json").write_text(
        (base / "checks" / "stencil27_f64.ref300.json").read_text())
    (base / "metrics" / "window.solves.py").write_text(
        "def read(ctx):\n    return float(len(ctx.times)) if ctx.times else None\n")
    spec = bench.spec
    spec["configs"].append({"name": "stencil27_f64_short", "source": "x", "reduced": ["max_iter"], "why": "x",
                            "file": "hpcbench/configs/stencil27_f64_short.json"})
    spec["workloads"].append({"name": "stencil27_f64_short.flat8", "config": "stencil27_f64_short",
                              "traffic": "flat8", "chips": 1, "why": "x"})
    spec["end_to_end"].append({"name": "window.solves", "unit": "solves", "better": "higher", "bound": 0.01,
                               "source": "host_clock", "workloads": ["stencil27_f64_short.flat8"]})
    out = run_cell(Bench(root=bench.root, spec=spec, base=base), "stencil27_f64_short.flat8", 5, 0.2, False,
                   device="cpu")
    assert out["correct"], out["checks"]
    assert out["metrics"]["window.solves"]["value"] == out["attempted"] > 0
    assert set(out["metrics"]) == {"gnnz_per_s", "solve_ms_p95", "setup_s", "window.solves"}


def test_a_four_chip_cell_added_as_files(bench):
    """A cell of four chips, added as files and entries only, runs through
    ``run_cell`` on a four-rank CPU mesh: its builder is told four devices,
    solves the z-stacked problem on them, and the comparison holds its x,
    unsharded, to the plain reference on the global grid."""
    bench, cell = mesh_cell(bench, 4)
    told = []

    def setup(config, problem, devices, spans):
        told.append(devices)
        return mesh_system()(config, problem, devices, spans)

    out = run_cell(bench, cell, 2**31 + 7, 0.2, False, device="cpu", system=setup)
    assert out["correct"] and out["attempted"] > 0, out["checks"]
    assert [tuple(map(str, t)) for t in told] == [("cpu",) * 4]
    assert set(out["metrics"]) == {"gnnz_per_s", "solve_ms_p95", "setup_s"}
    assert out["device"]["platform"] == "cpu" and out["device"]["memory_peak_bytes_per_card"] == []


def test_unknown_names_raise(bench):
    with pytest.raises(KeyError):
        bench.cell("nope")
    with pytest.raises(FileNotFoundError):
        bench.reader("no.such_metric")
