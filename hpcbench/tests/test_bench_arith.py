"""The metric arithmetic on synthetic data: nonzero counts, the least
bytes of an iteration, the 95th percentile, the idle share and idle gaps
from hand-made intervals, and a profile's events reduced per card."""

from __future__ import annotations

import statistics
import types

import pytest
import torch

from hpcbench import metrics
from hpcbench.inputs import permute_symmetric, stencil27_ell
from hpcbench.registry import Bench
from hpcbench.trace import STRETCH_SPAN, SOLVE_SPAN, Stretch, _idle_gaps, reduce_profile


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


def _event(name, start_us, end_us, card=None, id=0):
    """A profiler event: on the host (thread 1) where ``card`` is None,
    else a device operation on that card; ``id``: its correlation id."""
    cuda = torch.autograd.DeviceType.CUDA
    return types.SimpleNamespace(name=name, time_range=types.SimpleNamespace(start=start_us, end=end_us),
                                 device_type=cuda if card is not None else torch.autograd.DeviceType.CPU,
                                 device_index=card if card is not None else -1, thread=1,
                                 is_user_annotation=False, id=id)


def _profile(cards):
    """A stretch of 2 solves over [0, 100] us; each solve launches two
    kernels on each card of ``cards`` (a list of 4 indexes, repeated where
    the kernels share a card), card k's kernels shifted by k us."""
    host = [_event(STRETCH_SPAN, 0, 100), _event(SOLVE_SPAN, 1, 50), _event(SOLVE_SPAN, 51, 99),
            _event("launch", 10, 12), _event("sync", 60, 90)]
    device = []
    for k, card in enumerate(cards):
        for t0 in (0, 50):
            device.append(_event("spmv", t0 + 5 + k, t0 + 25 + k, card))
            device.append(_event("dot", t0 + 30 + k, t0 + 35 + k, card))
    return host + device


def _ctx(stretch, chips, n=10**9):
    problem = types.SimpleNamespace(n=n, nnz=27 * n, dtype=torch.float64)
    return types.SimpleNamespace(stretch=stretch, stretch_iters=2, problem=problem, explicit=False, chips=chips,
                                 device_kind="NVIDIA H100 80GB HBM3")


def _stretch(events, cards):
    window, busy, per_solve, ops, gaps = reduce_profile(events, 2, cards)
    return Stretch(None, window, tuple(cards), busy, sum(per_solve), per_solve, ops, gaps)


def test_a_profile_of_four_cards_reads_per_card():
    """Each card busy 2 x (20 + 5) us of 100: busy_s is the mean of the
    cards' busy times, the idle share the mean of theirs, the kernels and
    device_ops summed over the cards, each card's idle gaps named and
    summed."""
    bench = Bench()
    st = _stretch(_profile([0, 1, 2, 3]), [0, 1, 2, 3])
    assert st.busy_per_card() == pytest.approx([50e-6] * 4)
    assert st.busy_s == pytest.approx(50e-6) and st.window_s == pytest.approx(100e-6)
    assert st.idle_shares() == pytest.approx([0.5] * 4) and sorted(st.cards_ran) == [0, 1, 2, 3]
    assert st.kernels == 16 and st.per_solve == [8, 8]
    assert dict(st.device_ops) == pytest.approx({"spmv": 160e-6, "dot": 40e-6})
    # card k idles [0, 5+k], [25+k, 30+k] and [35+k, 55+k] with their
    # middles in the first solve ("launch", 10-12, holds none), [75+k, 80+k]
    # in "sync" (60-90) and [85+k, 100] in the second solve (51-99)
    gaps = dict(st.idle_gaps)
    assert gaps == pytest.approx({"sync": 4 * 5e-6, SOLVE_SPAN: 4 * 45e-6})
    ctx = _ctx(st, 4)
    assert bench.reader("device.idle_share")(ctx) == pytest.approx(0.5)
    assert bench.reader("solver.launches_per_iter")(ctx) == pytest.approx(8.0)
    least = metrics.least_bytes_per_iter(10**9, 27 * 10**9, 8, False) / 4
    expected = 100 * (least / 3.35e12) / (50e-6 / 2)
    assert bench.reader("kernels.iter_roofline")(ctx) == pytest.approx(expected)


def test_a_card_that_ran_nothing_counts_idle():
    st = _stretch(_profile([0, 0, 1, 1]), [0, 1, 2, 3])
    assert sorted(st.cards_ran) == [0, 1]
    assert st.busy_per_card()[2:] == [0.0, 0.0] and st.idle_shares()[2:] == [1.0, 1.0]
    assert st.kernels == 16


def test_the_same_events_on_one_card_read_as_one_pooled_timeline():
    """Every event on card 0: the numbers of one pooled timeline, as a
    one-card run read before per-card traces."""
    bench = Bench()
    events = _profile([0, 0, 0, 0])
    st = _stretch(events, [0])
    device = [(ev.time_range.start * 1e-6, ev.time_range.end * 1e-6) for ev in events if ev.device_index == 0]
    assert st.busy_s == pytest.approx(metrics.covered(device, 0.0, 100e-6))
    ctx = _ctx(st, 1)
    assert bench.reader("device.idle_share")(ctx) == pytest.approx(metrics.idle_share(device, 0.0, 100e-6))
    assert st.kernels == 16 and bench.reader("solver.launches_per_iter")(ctx) == pytest.approx(8.0)
    host = [(0.0, 100e-6, STRETCH_SPAN), (1e-6, 50e-6, SOLVE_SPAN), (51e-6, 99e-6, SOLVE_SPAN),
            (10e-6, 12e-6, "launch"), (60e-6, 90e-6, "sync")]
    assert dict(st.idle_gaps) == pytest.approx(dict(_idle_gaps(host, device, (0.0, 100e-6))))
    least = metrics.least_bytes_per_iter(10**9, 27 * 10**9, 8, False)
    assert bench.reader("kernels.iter_roofline")(ctx) == pytest.approx(100 * (least / 3.35e12) / (st.busy_s / 2))


def test_a_kernel_counts_for_the_solve_that_launched_it():
    """A card's clock can put a kernel past the end of its solve's span or
    into the next solve's; it counts for the solve whose span holds its
    launch (the runtime call with its correlation id), and the stretch
    stays sound. Without a launch in the trace, its own start decides.
    Kernels launched before the stretch (the pre-roll) are left out; one
    launched in the stretch before the first solve makes it unsound."""
    events = _profile([0, 0, 0, 0])
    events += [_event("cudaLaunchKernel", 48.0, 48.1, id=7), _event("finalize", 51.5, 51.8, 0, id=7),
               _event("cudaLaunchKernel", 98.0, 98.1, id=8), _event("finalize", 99.5, 99.8, 0, id=8),
               _event("cudaLaunchKernel", -2.0, -1.9, id=9), _event("preroll", 0.6, 0.7, 0, id=9)]
    events += [_event("preroll", -3.0 + 0.1 * k, -2.95 + 0.1 * k, 0) for k in range(8)]
    window, busy, per_solve, ops, gaps = reduce_profile(events, 2, [0])
    assert per_solve == [9, 9] and "preroll" not in dict(ops)
    assert all(s >= window[0] for s, _ in busy[0])
    events += [_event("cudaLaunchKernel", 0.2, 0.3, id=10), _event("stray", 1.5, 1.7, 0, id=10)]
    assert reduce_profile(events, 2, [0])[2] == [9, 9, -1]
