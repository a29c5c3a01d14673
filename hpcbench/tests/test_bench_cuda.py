"""Whole runs on the card at small grids (skipped without one): the
harness's own path, the port's kernels, the traced stretch; and a cell of
two chips on two cards (skipped below two)."""

from __future__ import annotations

import pytest
import torch

from hpcbench.run import run_cell

from conftest import mesh_cell, mesh_system, tiny_bench


def _card(count: int = 1):
    if not torch.cuda.is_available() or torch.cuda.device_count() < count:
        pytest.skip(f"needs {count} NVIDIA GPU(s)")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["stencil27_f64.ref300", "hpcrow27_f64.natural128", "hpcrow27_f64.scattered128"])
@pytest.mark.parametrize("trace", [False, True])
def test_cell_on_the_card(tmp_path, cell, trace):
    _card()
    bench = tiny_bench(tmp_path, grid=40, max_iter=150)
    out = run_cell(bench, cell, 2**31 + 99, 1.0, trace)
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu" and out["device"]["memory_peak_bytes"] > 0
    if trace:
        assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"]
        assert out["metrics"]["solver.launches_per_iter"]["value"] >= 1
        assert 0 <= out["metrics"]["device.idle_share"]["value"] < 1


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [False, True])
def test_two_chip_cell_on_two_cards(tmp_path, trace):
    """A two-rank mesh cell, one rank a card (``auto``: K7 with halo
    planes): the run counts two cards and reads a peak on each."""
    _card(2)
    bench, cell = mesh_cell(tiny_bench(tmp_path), 2, grid=(32, 32, 64), max_iter=150)
    out = run_cell(bench, cell, 2**31 + 98, 1.0, trace, system=mesh_system("auto"))
    assert out["correct"], out["checks"]
    dev = out["device"]
    assert dev["count"] == 2 and len(dev["memory_peak_bytes_per_card"]) == 2
    assert all(peak > 0 for peak in dev["memory_peak_bytes_per_card"])
    assert dev["memory_peak_bytes"] == max(dev["memory_peak_bytes_per_card"])
    if trace:
        assert 0 < dev["busy_s"] <= dev["window_s"]
        assert len(out["notes"]["idle_share_per_card"]) == 2
