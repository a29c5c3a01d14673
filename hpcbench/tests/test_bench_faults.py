"""Whole runs on the CPU (the look for a chip skipped), with the timed
path broken underneath: ``correct`` has to come out false.

The faults a cell of one chip can have: a solve that returns its state
unchanged, half of the rows left out of the dot products (the mean taken
over the rest), and an answer altered where it is produced (x, normr).
No cell exchanges data between chips."""

from __future__ import annotations

import dataclasses

import pytest
import torch

import hpccg_tpu_torch.solver as port_solver
from hpcbench import systems
from hpcbench.run import run_cell

CELLS = ["stencil27_f64.ref300", "hpcrow27_f64.scattered128"]


def _wrapped(change):
    """A builder that runs the configuration's own and alters each result."""

    def setup(config, problem, device, spans):
        runner = systems.setup(config["system"], config, problem, device, spans)
        solve = runner.solve_fn
        runner.solve_fn = lambda b, x0: change(solve(b, x0), x0)
        return runner

    return setup


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(bench, cell):
    out = run_cell(bench, cell, 2**31 + 11, 0.2, False, device="cpu")
    assert out["correct"] and out["failed"] == 0 and out["attempted"] > 0, out["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_state_returned_unchanged(bench, cell):
    def unchanged(res, x0):
        return dataclasses.replace(res, x=x0.clone(), trace=torch.full_like(res.trace, float(res.trace[0])))

    out = run_cell(bench, cell, 2**31 + 12, 0.2, False, device="cpu", system=_wrapped(unchanged))
    assert not out["correct"] and out["failed"] == out["attempted"]


@pytest.mark.parametrize("cell", CELLS)
def test_half_the_rows_left_out_of_the_dots(bench, cell, monkeypatch):
    def half(us, vs, device, dtype=None):
        u, v = us[0], vs[0]
        m = u.numel() // 2
        return (2.0 * torch.dot(u[:m], v[:m])).reshape(1).to(dtype or u.dtype)

    monkeypatch.setattr(port_solver, "_dot_parts", half)
    out = run_cell(bench, cell, 2**31 + 13, 0.2, False, device="cpu")
    assert not out["correct"]
    assert out["checks"]["trace_rel"]["value"] > out["checks"]["trace_rel"]["limit"]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("what", ["x", "normr"])
def test_answer_altered_where_produced(bench, cell, what):
    def altered(res, x0):
        if what == "x":
            x = res.x.clone()
            x[x.numel() // 3] += 1e-6
            return dataclasses.replace(res, x=x)
        return dataclasses.replace(res, normr=res.normr * (1 + 1e-8))

    out = run_cell(bench, cell, 2**31 + 14, 0.2, False, device="cpu", system=_wrapped(altered))
    assert not out["correct"]
    name = "x_rel" if what == "x" else "normr_rel"
    assert out["checks"][name]["value"] > out["checks"][name]["limit"]


@pytest.mark.parametrize("cell", CELLS)
def test_float32_control_is_not_correct(bench, cell):
    from hpcbench.control import reference_runner

    out = run_cell(bench, cell, 2**31 + 15, 0.2, False, device="cpu",
                   system=lambda config, problem, device, spans: reference_runner(config, problem, device))
    assert not out["correct"]
