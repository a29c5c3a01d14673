"""The ``program_span`` metrics: their readers on synthetic records, the
stretch that collects the port's spans (``hpcbench.program_spans``) at a
tiny grid on the CPU, a traced line that reports them, and a port without
``utils.trace`` (a parent commit), whose traced run leaves them out."""

from __future__ import annotations

import collections
import math
import sys
import types

import pytest
import torch

from hpcbench import inputs, program_spans
from hpcbench.run import Context, run_cell

from conftest import TINY_LIMITS

Rec = collections.namedtuple("Rec", "name parent start end")
NEW = ["solver.host_us_per_iter", "solver.exit_syncs_per_solve", "reorder.band_s", "reorder.to_dia_s",
       "reorder.rcm_s"]


def _synthetic():
    """Two solves of 149 iterations, the flag read 10 times each, and a
    set-up whose chooser took two band passes, an RCM order and no DIA."""
    loop = []
    for s in range(2):
        top = len(loop)
        loop.append(Rec("solver.solve", -1, 0, 10**9))
        loop.append(Rec("solver.start", top, 0, 1000))
        for i in range(10):
            loop.append(Rec("solver.exit_read", top, 0, 5000))
            loop.append(Rec("solver.issue", top, 0, 2_000_000))
        loop.append(Rec("solver.finish", top, 0, 100))
    setup = [Rec("reorder.auto_structure", -1, 0, 9 * 10**9), Rec("reorder.band", 0, 0, 2 * 10**9),
             Rec("reorder.rcm", 0, 2 * 10**9, 5 * 10**9), Rec("reorder.permute", 0, 5 * 10**9, 6 * 10**9),
             Rec("reorder.band", 0, 6 * 10**9, 8_500_000_000), Rec("solver.prepare", -1, 0, 10**6)]
    return types.SimpleNamespace(setup_spans=setup, loop_spans=loop, loop_iters=2 * 149)


def test_readers_on_synthetic_records(bench):
    ctx = _synthetic()
    got = {name: bench.reader(name)(ctx) for name in NEW}
    assert got["solver.host_us_per_iter"] == pytest.approx(2 * 10 * 2000.0 / (2 * 149))
    assert got["solver.exit_syncs_per_solve"] == 10.0
    assert got["reorder.band_s"] == pytest.approx(4.5)
    assert got["reorder.rcm_s"] == pytest.approx(3.0)
    assert got["reorder.to_dia_s"] is None  # no DIA: nothing to read


def test_readers_read_nothing_without_spans(bench):
    ctx = types.SimpleNamespace(setup_spans=None, loop_spans=None, loop_iters=0)
    assert all(bench.reader(name)(ctx) is None for name in NEW)


def _context(bench, cell: str, seed: int = 7) -> Context:
    entry = bench.cell(cell)
    config, traffic = bench.config(entry["config"]), bench.traffic(entry["traffic"])
    return Context(entry, config, traffic, inputs.make(config, traffic, seed, "cpu"), "cpu", "cpu")


@pytest.mark.parametrize("cell", ["hpcrow27_f64.natural128", "hpcrow27_f64.scattered128",
                                  "stencil27_f64.ref300"])
def test_the_stretch_collects_the_ports_spans(bench, cell, capsys):
    ctx = _context(bench, cell)
    assert not program_spans.gather(ctx, bench.base / "checks")  # off the card: nothing runs
    assert ctx.loop_spans is None
    ctx = _context(bench, cell)
    program_spans.collect(ctx, TINY_LIMITS)
    solves = int(ctx.traffic["trace_solves"])
    max_iter = ctx.config["max_iter"]
    assert ctx.loop_iters == solves * (max_iter - 1)
    loop = collections.Counter(r.name for r in ctx.loop_spans)
    # on the CPU the flag is read every iteration (check_every 1)
    assert loop["solver.solve"] == solves and loop["solver.exit_read"] == solves * (max_iter - 1)
    setup = collections.Counter(r.name for r in ctx.setup_spans)
    if cell == "stencil27_f64.ref300":
        assert not any(name.startswith("reorder.") for name in setup)
    else:
        assert setup["reorder.auto_structure"] == 1 and setup["solver.prepare"] == 1
        natural = cell.endswith("natural128")
        assert setup["reorder.band"] == (1 if natural else 2) and setup["reorder.rcm"] == (0 if natural else 1)
    assert "hpcbench: the port's spans" in capsys.readouterr().err
    from hpccg_tpu_torch.utils import trace

    assert not trace.enabled() and trace.take() == []


def test_the_stretch_holds_its_solves_to_the_limits(bench):
    ctx = _context(bench, "hpcrow27_f64.natural128")
    limits = {**TINY_LIMITS, "limits": {**TINY_LIMITS["limits"], "x_rel": -1.0}}
    with pytest.raises(RuntimeError, match="failed the comparison"):
        program_spans.collect(ctx, limits)


@pytest.mark.parametrize("cell, expected", [
    ("hpcrow27_f64.natural128", {"reorder.structure_s", "solver.host_us_per_iter", "solver.exit_syncs_per_solve",
                                 "reorder.band_s", "reorder.to_dia_s"}),
    ("hpcrow27_f64.scattered128", {"reorder.structure_s", "solver.host_us_per_iter",
                                   "solver.exit_syncs_per_solve", "reorder.band_s", "reorder.rcm_s"}),
    ("stencil27_f64.ref300", {"solver.host_us_per_iter", "solver.exit_syncs_per_solve"}),
])
def test_a_traced_line_reports_the_host_metrics(bench, monkeypatch, cell, expected):
    """The traced line at a tiny grid, the stretch let run on the CPU: the
    host-clock and program-span metrics that a tiny cell can read (the
    device-trace ones need a card)."""
    monkeypatch.setattr(program_spans, "DEVICE_TYPE", "cpu")
    out = run_cell(bench, cell, 4_000_000_123, 0.2, True, device="cpu")
    assert out["correct"] and set(out["metrics"]) == expected
    max_iter = bench.config(bench.cell(cell)["config"])["max_iter"]
    assert out["metrics"]["solver.exit_syncs_per_solve"]["value"] == max_iter - 1
    assert all(m["value"] > 0 for m in out["metrics"].values())


def test_a_port_without_the_recorder_leaves_the_metrics_out(bench, monkeypatch):
    import hpccg_tpu_torch.utils

    monkeypatch.setattr(program_spans, "DEVICE_TYPE", "cpu")
    monkeypatch.delattr(hpccg_tpu_torch.utils, "trace")
    monkeypatch.setitem(sys.modules, "hpccg_tpu_torch.utils.trace", None)  # the import fails
    out = run_cell(bench, "hpcrow27_f64.natural128", 2**31 + 5, 0.2, True, device="cpu")
    assert out["correct"] and set(out["metrics"]) == {"reorder.structure_s"}


def test_summary_counts_and_sums():
    ctx = _synthetic()
    got = program_spans.summary(ctx.loop_spans)
    assert got["solver.exit_read"] == [20, pytest.approx(20 * 5e-6)]
    assert math.isclose(program_spans.total_s(ctx.loop_spans, "solver.solve"), 2.0)
    assert torch.device("cpu").type != program_spans.DEVICE_TYPE
