"""Whole runs on the CPU (the look for a chip skipped), with the timed
path broken underneath: ``correct`` has to come out false.

The faults a cell of one chip can have: a solve that returns its state
unchanged, half of the rows left out of the dot products (the mean taken
over the rest), and an answer altered where it is produced (x, normr).
The faults that only a cell of several chips can have, on a four-rank CPU
mesh (``conftest.mesh_cell``): one rank's halo plane left at zero, and one
rank's dot-product partial dropped from the sum."""

from __future__ import annotations

import dataclasses

import pytest
import torch

import hpccg_tpu_torch.parallel.halo as port_halo
import hpccg_tpu_torch.solver as port_solver
from hpcbench import systems
from hpcbench.run import run_cell

from conftest import mesh_cell, mesh_system

CELLS = ["stencil27_f64.ref300", "hpcrow27_f64.scattered128"]


def _wrapped(change):
    """A builder that runs the configuration's own and alters each result."""

    def setup(config, problem, devices, spans):
        runner = systems.setup(config["system"], config, problem, devices, spans)
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
                   system=lambda config, problem, devices, spans: reference_runner(config, problem, devices[0]))
    assert not out["correct"]


def test_sound_mesh_run_is_correct(bench):
    bench, cell = mesh_cell(bench, 4)
    out = run_cell(bench, cell, 2**31 + 16, 0.2, False, device="cpu", system=mesh_system())
    assert out["correct"] and out["failed"] == 0 and out["attempted"] > 0, out["checks"]
    assert out["notes"]["ranks"] == 4


def test_one_ranks_halo_plane_left_at_zero(bench, monkeypatch):
    exchange = port_halo.exchange_halo

    def dropped(grids):
        planes = exchange(grids)
        below, above = planes[2]
        planes[2] = (torch.zeros_like(below), above)  # rank 2 never receives rank 1's top plane
        return planes

    monkeypatch.setattr(port_halo, "exchange_halo", dropped)
    bench, cell = mesh_cell(bench, 4)
    out = run_cell(bench, cell, 2**31 + 17, 0.2, False, device="cpu", system=mesh_system())
    assert not out["correct"] and out["failed"] == out["attempted"]
    assert out["checks"]["trace_rel"]["value"] > out["checks"]["trace_rel"]["limit"]


def test_one_ranks_dot_partial_dropped(bench, monkeypatch):
    dot_parts = port_solver._dot_parts

    def dropped(us, vs, device, dtype=None):
        parts = dot_parts(us, vs, device, dtype)
        if len(us) > 1:
            parts = parts.clone()
            parts[1] = 0  # rank 1's partial left out of the allreduce
        return parts

    monkeypatch.setattr(port_solver, "_dot_parts", dropped)
    bench, cell = mesh_cell(bench, 4)
    out = run_cell(bench, cell, 2**31 + 18, 0.2, False, device="cpu", system=mesh_system())
    assert not out["correct"] and out["failed"] == out["attempted"]
    assert out["checks"]["trace_rel"]["value"] > out["checks"]["trace_rel"]["limit"]
