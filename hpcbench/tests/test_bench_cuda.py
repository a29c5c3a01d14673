"""Whole runs on the card at small grids (skipped without one): the
harness's own path, the port's kernels, the traced stretch."""

from __future__ import annotations

import pytest
import torch

from hpcbench.run import run_cell

from conftest import tiny_bench


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


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
