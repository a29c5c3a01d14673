"""The port's span recorder (``hpccg_tpu_torch.utils.trace``) and where its
spans sit: the CG host loops (``cg_solve``, ``cg_solve_fused``) under
``make_cg``'s ``solver.solve``, the explicit path's ``solver.prepare``, and
the structure chooser's steps under ``reorder.auto_structure``.

Off (the default) the recorder reads no clock, records nothing and never
enters ``torch.profiler.record_function``, and the loops do nothing more
per iteration than without it; on, the results are bit for bit those of a
solve with tracing off."""

import math
from collections import Counter

import numpy as np
import pytest
import torch

from hpccg_tpu_torch import ProblemConfig, make_cg
from hpccg_tpu_torch.models.stencil import generate_ell, generate_problem
from hpccg_tpu_torch.reorder import auto_structure, permute_ell
from hpccg_tpu_torch.utils import trace

GRID = (6, 5, 4)


@pytest.fixture(autouse=True)
def _recorder_off():
    trace.disable()
    trace.take()
    yield
    trace.disable()
    trace.take()


def _fail(*args, **kwargs):
    raise AssertionError("called with tracing off")


def _solver(case: str, max_iter: int = 20, check_every=4, tolerance: float = 0.0, grid=GRID, device="cpu"):
    """(solve, b, x0) of a small float64 problem on ``case``'s path:
    ``cg_solve`` (stencil, pallas, an ELL or DIA matrix) or
    ``cg_solve_fused`` (pallas_fused)."""
    kw = dict(max_iter=max_iter, check_every=check_every, tolerance=tolerance)
    prob = generate_problem(ProblemConfig(*grid, dtype=torch.float64), device)
    if case in ("ell", "dia"):
        A = generate_ell(ProblemConfig(*grid, dtype=torch.float64), device).A
        return make_cg(A.to_dia() if case == "dia" else A, **kw), prob.b, prob.x0
    return make_cg(prob.A, backend=case, **kw), prob.b, prob.x0


CASES = ["stencil", "pallas", "pallas_fused", "ell", "dia"]


def _counts(records) -> Counter:
    return Counter(r.name for r in records)


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int64) if t.dtype == torch.float64 else t


def _scattered(seed: int = 1):
    A = generate_ell(ProblemConfig(*GRID, dtype=torch.float64), "cpu").A
    return permute_ell(A, np.random.default_rng(seed).permutation(A.local_nrow))


def test_off_by_default_records_nothing_and_calls_no_profiler_or_clock(monkeypatch):
    assert not trace.enabled()
    monkeypatch.setattr(torch.profiler, "record_function", _fail)
    monkeypatch.setattr(trace, "perf_counter_ns", _fail)
    for case in CASES:
        solve, b, x0 = _solver(case)
        assert int(solve(b, x0).niters) == 19
    auto_structure(_scattered())
    assert trace.take() == []
    assert trace.span("a") is trace.span("b")


def test_on_outside_a_profiler_enters_no_record_function(monkeypatch):
    monkeypatch.setattr(torch.profiler, "record_function", _fail)
    trace.enable()
    solve, b, x0 = _solver("stencil")
    solve(b, x0)
    assert _counts(trace.take())["solver.solve"] == 1


@pytest.mark.parametrize("case", ["stencil", "pallas_fused", "ell"])
def test_off_adds_nothing_per_iteration(monkeypatch, case):
    """With tracing off the loops call the recorder a fixed number of times
    a solve, however many iterations run."""
    calls = Counter()

    def counted(name):
        def fn(*args, **kwargs):
            calls[name] += 1
            return real[name](*args, **kwargs)
        return fn

    real = {"span": trace.span, "enabled": trace.enabled}
    for name in real:
        monkeypatch.setattr(trace, name, counted(name))
    per_solve = []
    for max_iter in (20, 60):
        solve, b, x0 = _solver(case, max_iter=max_iter)
        calls.clear()
        assert int(solve(b, x0).niters) == max_iter - 1
        per_solve.append(dict(calls))
    assert per_solve[0] == per_solve[1] and sum(per_solve[0].values()) <= 4
    assert trace.take() == []


def test_spans_nest_with_their_parents():
    trace.enable()
    with trace.span("a"):
        with trace.span("b"):
            pass
        with trace.span("c"):
            with trace.span("d"):
                pass
    with trace.span("e"):
        pass
    records = trace.take()
    assert [(r.name, r.parent) for r in records] == [("a", -1), ("b", 0), ("c", 0), ("d", 2), ("e", -1)]
    for r in records:
        assert r.start <= r.end
        if r.parent >= 0:
            outer = records[r.parent]
            assert outer.start <= r.start and r.end <= outer.end
    assert trace.take() == []


def test_spans_left_open_by_an_exception_end_with_their_parent():
    trace.enable()

    def body():
        with trace.span("outer"):
            trace.span("inner").__enter__()
            raise ValueError

    with pytest.raises(ValueError):
        body()
    with trace.span("after"):
        pass
    outer, inner, after = trace.take()
    assert inner.parent == 0 and inner.end == outer.end and after.parent == -1


@pytest.mark.parametrize("case", CASES)
def test_loop_spans_of_a_solve(case):
    """check_every 4, max_iter 20: 19 iterations, the flag read at 0, 4, 8,
    12 and 16, ceil(19 / 4) = 5 reads, each followed by a chunk of
    launches."""
    solve, b, x0 = _solver(case)
    trace.enable()
    res = solve(b, x0)
    records = trace.take()
    assert int(res.niters) == 19
    counts = _counts(records)
    assert counts == {"solver.solve": 1, "solver.start": 1, "solver.finish": 1,
                      "solver.exit_read": math.ceil(19 / 4), "solver.issue": math.ceil(19 / 4)}
    assert records[0].name == "solver.solve" and records[0].parent == -1
    assert all(r.parent == 0 for r in records[1:])
    assert [r.name for r in records[1:]] == ["solver.start"] + ["solver.exit_read", "solver.issue"] * 5 + [
        "solver.finish"]
    for prev, nxt in zip(records[1:], records[2:]):
        assert prev.end <= nxt.start


def test_a_solve_that_stops_early_ends_on_its_read():
    solve, b, x0 = _solver("stencil", max_iter=150, tolerance=1e-6)
    trace.enable()
    res = solve(b, x0)
    names = [r.name for r in trace.take()]
    reads = names.count("solver.exit_read")
    assert int(res.niters) < 149 and reads == math.ceil(int(res.niters) / 4) + 1
    assert names.count("solver.issue") == reads - 1 and names[-2:] == ["solver.exit_read", "solver.finish"]


@pytest.mark.parametrize("case", CASES)
def test_results_are_bit_for_bit_with_tracing_on_and_off(case):
    solve, b, x0 = _solver(case)
    off = solve(b, x0)
    trace.enable()
    on = solve(b, x0)
    assert trace.take()
    for field in ("x", "niters", "normr", "trace"):
        assert torch.equal(_bits(getattr(off, field)), _bits(getattr(on, field))), field


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["auto", "ell", "dia"])
def test_on_the_card_spans_change_no_bit_and_the_flag_is_read_every_16(case):
    """K3/K4 (``auto``: pallas_fused), K12 and K10 at 32^3, 150 iterations
    at the card's default ``check_every`` (16): 10 reads a solve."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda is not available)")
    solve, b, x0 = _solver(case, max_iter=150, check_every=None, grid=(32, 32, 32), device="cuda")
    off = solve(b, x0)
    trace.enable()
    on = solve(b, x0)
    counts = _counts(trace.take())
    assert int(on.niters) == 149 and counts["solver.exit_read"] == 10 and counts["solver.issue"] == 10
    assert counts["solver.solve"] == counts["solver.start"] == counts["solver.finish"] == 1
    for field in ("x", "niters", "normr", "trace"):
        assert torch.equal(_bits(getattr(off, field)), _bits(getattr(on, field))), field


def test_explicit_solver_prepares_inside_a_span():
    A = generate_ell(ProblemConfig(*GRID, dtype=torch.float64), "cpu").A
    trace.enable()
    make_cg(A.to_dia())
    make_cg(A)
    assert [(r.name, r.parent) for r in trace.take()] == [("solver.prepare", -1)] * 2


def test_structure_chooser_steps_on_a_natural_and_a_scattered_matrix():
    natural = generate_ell(ProblemConfig(*GRID, dtype=torch.float64), "cpu").A
    scattered = _scattered()
    trace.enable()
    _, perm, report = auto_structure(natural)
    records = trace.take()
    assert perm is None and report.format == "dia"
    assert _counts(records) == {"reorder.auto_structure": 1, "reorder.band": 1, "reorder.to_dia": 1}
    assert records[0].name == "reorder.auto_structure" and all(r.parent == 0 for r in records[1:])

    _, perm, report = auto_structure(scattered)
    records = trace.take()
    assert perm is not None and report.format in ("ell+rcm", "dia+rcm")
    expected = {"reorder.auto_structure": 1, "reorder.band": 2, "reorder.rcm": 1, "reorder.permute": 1}
    if report.format == "dia+rcm":
        expected["reorder.to_dia"] = 1
    assert _counts(records) == expected
    assert [r.name for r in records[1:4]] == ["reorder.band", "reorder.rcm", "reorder.permute"]
    assert all(r.parent == 0 for r in records[1:])


def test_solver_spans_lie_inside_the_harness_solve_span_under_the_profiler():
    from torch.profiler import ProfilerActivity, profile, record_function

    from hpcbench.trace import SOLVE_SPAN

    solve, b, x0 = _solver("ell")
    trace.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(SOLVE_SPAN):
            solve(b, x0)
    events = prof.events()
    (outer,) = [ev for ev in events if ev.name == SOLVE_SPAN]
    ours = [ev for ev in events if ev.name.startswith("solver.")]
    assert Counter(ev.name for ev in ours) == {"solver.solve": 1, "solver.start": 1, "solver.finish": 1,
                                               "solver.exit_read": 5, "solver.issue": 5}
    for ev in ours:
        assert outer.time_range.start <= ev.time_range.start <= ev.time_range.end <= outer.time_range.end
        assert ev.thread == outer.thread
    assert _counts(trace.take()) == Counter(ev.name for ev in ours)
