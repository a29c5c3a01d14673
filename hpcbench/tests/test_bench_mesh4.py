"""The cell ``stencil27_f64_mpi4.weak64x4``: the reference's MPI weak-scaling
run at four ranks, one a card, through ``make_distributed_cg(...,
backend="collective")`` (the ``mesh`` builder). On the CPU its
configuration runs through the harness on a four-rank CPU mesh at a tiny
grid, and its three per-layer readers read synthetic records; on four
cards (skipped below four) the cell runs as the benchmark runs it."""

from __future__ import annotations

import collections
import json
import types

import pytest
import torch

from hpcbench.registry import Bench
from hpcbench.run import run_cell

from conftest import tiny_bench

CELL = "stencil27_f64_mpi4.weak64x4"
NEW = ["collective.issue_us_per_solve", "collective.wait_share", "kernels.collective_roofline"]
Rec = collections.namedtuple("Rec", "name parent start end")
Count = collections.namedtuple("Count", "name rank value at")


def _tiny(tmp_path) -> Bench:
    """The real cells cut to tiny grids, this cell to 8x6x16 (4 ranks of
    8x6x4) and 20 iterations."""
    bench = tiny_bench(tmp_path)
    path = bench.base / "traffic" / f"{bench.cell(CELL)['traffic']}.json"
    path.write_text(json.dumps({**json.loads(path.read_text()), "grid": [8, 6, 16]}))
    return bench


def test_the_configuration_names_its_deployment():
    bench = Bench()
    cell = bench.cell(CELL)
    config, traffic = bench.config(cell["config"]), bench.traffic(cell["traffic"])
    assert cell["chips"] == config["ranks"] == 4 and config["system"] == "mesh"
    assert (config["backend"], config["method"], config["dtype"], config["tolerance"]) == \
        ("collective", "cg", "float64", 0.0)
    nx, ny, nz = traffic["grid"]
    assert [nx, ny, nz // cell["chips"]] == config["rank_grid"] == [64, 64, 64]
    assert config["reduced"] == [] and "weakScalingRunScript" in config["source"]
    assert {m["name"] for m in bench.metrics(CELL, True)} == set(NEW)


@pytest.mark.parametrize("trace", [False, True])
def test_the_cell_through_the_harness_on_four_cpu_ranks(tmp_path, trace):
    """Its builder told four CPU ranks solves on them; the comparison holds
    the unsharded x to the plain reference on the global grid. Off a card
    the three per-layer metrics find nothing to read."""
    out = run_cell(_tiny(tmp_path), CELL, 2**31 + 21, 0.2, trace, device="cpu")
    assert out["correct"] and out["attempted"] > 0, out["checks"]
    assert out["notes"]["ranks"] == 4 and out["notes"]["backend"] == "collective"
    if trace:
        assert not set(NEW) & set(out["metrics"])
    else:
        assert set(out["metrics"]) == {"gnnz_per_s", "solve_ms_p95", "setup_s"}


def _synthetic(bench):
    """Set-up: a peer set-up and 5 warm-up solves; then 8 solves of 149
    iterations on 4 cards, each issued in 300 us, block 0 of each rank
    waiting 2 ms of a 5 ms kernel; the trace holds 8 x 4 launches of 4.4
    ms of K15."""
    setup, counts, t = [Rec("collective.peer_setup", -1, 0, 10**6)], [], 10**6
    for _ in range(5):
        setup.append(Rec("collective.issue", -1, t, t + 400_000))
        counts += [Count("collective.wait_ns", r, 9 * 10**6, t + 10**7) for r in range(4)]
        counts += [Count("collective.kernel_ns", r, 10**7, t + 10**7) for r in range(4)]
        t += 2 * 10**7
    loop = []
    for _ in range(8):
        loop.append(Rec("collective.issue", -1, t, t + 300_000))
        counts += [Count(name, r, v, t + 6 * 10**6) for r in range(4)
                   for name, v in (("collective.wait_ns", 2 * 10**6), ("collective.kernel_ns", 5 * 10**6))]
        t += 10**7
    problem = types.SimpleNamespace(n=64 * 64 * 256, nnz=27_652_600, dtype=torch.float64)
    stretch = types.SimpleNamespace(device_ops=[
        ["void (anonymous namespace)::collective_kernel<double, double, 27, 0, (cuda::std::__4::__detail::"
         "thread_scope)0>(...)", 32 * 4.4e-3], ["Memset (Device)", 1e-5]])
    ctx = types.SimpleNamespace(setup_spans=setup, loop_spans=loop, loop_iters=8 * 149, traffic={"trace_solves": 8},
                                stretch=stretch, stretch_iters=8 * 149, device_kind="NVIDIA H100 80GB HBM3",
                                problem=problem, chips=4, explicit=False)
    return ctx, counts


def test_readers_on_synthetic_records(bench, monkeypatch):
    from hpccg_tpu_torch.utils import trace

    ctx, counts = _synthetic(bench)
    monkeypatch.setattr(trace, "take_counts", lambda: counts)
    got = {name: bench.reader(name)(ctx) for name in NEW}
    assert got["collective.issue_us_per_solve"] == pytest.approx(300.0)
    assert got["collective.wait_share"] == pytest.approx(0.4)  # the warm-up's 0.9 left out
    least = 6 * 8 * 64 * 64 * 256 / 4 / 3.35e12
    assert got["kernels.collective_roofline"] == pytest.approx(100 * least / (4.4e-3 / 149))  # a launch a card a solve


def test_readers_read_nothing_without_the_ports_records(bench, monkeypatch):
    """A port without the spans, the counts or the kernel (a parent commit,
    a traced run off a card) leaves the three metrics out."""
    from hpccg_tpu_torch.utils import trace

    ctx, _ = _synthetic(bench)
    ctx.loop_spans = [Rec("solver.issue", -1, 0, 10)]
    ctx.stretch.device_ops = [["void dia_spmv_kernel<double>(...)", 1.0]]
    monkeypatch.delattr(trace, "take_counts")
    assert all(bench.reader(name)(ctx) is None for name in NEW)
    empty = types.SimpleNamespace(setup_spans=None, loop_spans=None, loop_iters=0, stretch=None, stretch_iters=0)
    assert all(bench.reader(name)(empty) is None for name in NEW)


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [False, True])
def test_the_cell_on_four_cards(trace):
    """The real cell, a 2 s window or a traced stretch: ``correct``, four
    cards used, one K15 launch per card a solve, the new metrics read."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs 4 NVIDIA GPUs")
    out = run_cell(Bench(), CELL, 2**31 + 123, 2.0, trace)
    assert out["correct"], out["checks"]
    assert out["device"]["count"] == 4 and len(out["device"]["memory_peak_bytes_per_card"]) == 4
    if trace:
        m = {k: v["value"] for k, v in out["metrics"].items()}
        assert set(NEW) <= set(m), m
        assert 0 < m["kernels.collective_roofline"] < 100 and 0 <= m["collective.wait_share"] < 1
        assert m["collective.issue_us_per_solve"] > 0
        assert len(out["notes"]["idle_share_per_card"]) == 4
