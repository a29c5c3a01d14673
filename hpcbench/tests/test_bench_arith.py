"""The metric arithmetic on synthetic data: nonzero counts, the least
bytes of an iteration, the 95th percentile, and the idle share and idle
gaps from hand-made intervals."""

from __future__ import annotations

import statistics

import pytest
import torch

from hpcbench import metrics
from hpcbench.inputs import permute_symmetric, stencil27_ell
from hpcbench.trace import _idle_gaps


@pytest.mark.parametrize("grid", [(1, 1, 1), (2, 3, 4), (5, 4, 3), (7, 7, 7)])
def test_nnz_formula_counts_the_generated_matrix(grid):
    vals, cols, valid = stencil27_ell(*grid, "cpu")
    assert int(valid.sum()) == metrics.stencil27_nnz(*grid)
    assert int((vals != 0).sum()) == metrics.stencil27_nnz(*grid)


def test_nnz_of_the_cells():
    assert metrics.stencil27_nnz(300, 300, 300) == 724_150_792
    assert metrics.stencil27_nnz(100, 100, 100) == 26_463_592
    assert metrics.stencil27_nnz(128, 128, 128) == 55_742_968


def test_least_bytes_of_the_cells():
    n300, n128 = 300 ** 3, 128 ** 3
    assert metrics.least_bytes_per_iter(n300, metrics.stencil27_nnz(300, 300, 300), 8, False) == 1_296_000_000
    explicit = metrics.least_bytes_per_iter(n128, metrics.stencil27_nnz(128, 128, 128), 8, True)
    assert explicit == 48 * n128 + 8 * 55_742_968
    assert abs(explicit / 3.35e12 - 163.2e-6) < 0.1e-6


def test_p95_interpolates_between_order_statistics():
    values = list(range(1, 101))
    assert metrics.p95(values) == pytest.approx(95.05)
    assert metrics.p95([3.0]) == 3.0
    assert metrics.p95(values) == statistics.quantiles(values, n=20, method="inclusive")[18]


def test_union_and_idle_share_from_intervals():
    busy = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.6)]
    assert metrics.union(busy) == [(0.0, 2.0), (3.0, 4.0)]
    assert metrics.covered(busy, 0.0, 5.0) == pytest.approx(3.0)
    assert metrics.idle_share(busy, 0.0, 5.0) == pytest.approx(0.4)
    assert metrics.idle_share(busy, 1.0, 3.5) == pytest.approx(0.4)
    assert metrics.idle_share(busy, 1.5, 3.0) == pytest.approx(2 / 3)
    assert metrics.idle_share([], 0.0, 2.0) == 1.0
    with pytest.raises(ValueError):
        metrics.idle_share(busy, 1.0, 1.0)


def test_idle_gaps_go_to_the_innermost_host_span():
    host = [(0.0, 10.0, "solve"), (1.0, 2.0, "launch"), (4.0, 7.0, "sync"), (5.0, 5.5, "copy")]
    busy = [(0.0, 1.5), (2.0, 4.5), (5.6, 9.0)]
    gaps = dict(_idle_gaps(host, busy, (0.0, 10.0)))
    # gaps: (1.5, 2.0) mid 1.75 in launch; (4.5, 5.6) mid 5.05 in copy; (9, 10) mid 9.5 in solve
    assert gaps == pytest.approx({"launch": 0.5, "copy": 1.1, "solve": 1.0})


def test_symmetric_permutation_is_p_a_pt():
    vals, cols, valid = stencil27_ell(3, 4, 2, "cpu")
    n = 24
    dense = torch.zeros(n, n, dtype=torch.float64)
    rows = torch.arange(n)[:, None].expand(cols.shape)
    dense[rows[valid], cols[valid].long()] = vals[valid]
    perm = torch.randperm(n, generator=torch.Generator().manual_seed(3))
    pv, pc, pm = permute_symmetric(vals, cols, valid, perm)
    pdense = torch.zeros(n, n, dtype=torch.float64)
    pdense[rows[pm], pc[pm].long()] = pv[pm]
    assert torch.equal(pdense, dense[perm][:, perm])
