"""The collective whole-solve kernels K15/K16 across cards, on the CPU: how a
mesh's ranks group by card and what each card's pointer table names, the
collective backend on a four-rank mesh against the benchmark's plain
reference, and its spans and counts.

A launch across cards runs one group of consecutive ranks a card; every
card holds a copy of the NKIND x ndev pointer table that names every
rank's buffers, the other cards' at their peer addresses
(``ops/cuda/collective.py``). The launches themselves run on the card only
(``tests/test_torch_cuda.py``); here the shards lie on the CPU and the
wrapper runs the plain version, which records the same spans and counts."""

import time

import pytest
import torch

from hpcbench.inputs import make as make_inputs
from hpcbench.reference import matvec as reference_matvec
from hpcbench.reference.cg import cg as reference_cg
from hpcbench.registry import Bench
from hpccg_tpu_torch import ProblemConfig
from hpccg_tpu_torch.ops.cuda import collective as col
from hpccg_tpu_torch.parallel import make_distributed_cg, make_mesh
from hpccg_tpu_torch.utils import trace

CELL = "stencil27_f64_mpi4.weak64x4"
GRID = (8, 6, 16)  # the cell's 64x64x256 cut for the CPU: 4 ranks of 8x6x4


@pytest.fixture(autouse=True)
def _recorder_off():
    trace.disable()
    trace.take()
    trace.take_counts()
    yield
    trace.disable()
    trace.take()
    trace.take_counts()


@pytest.mark.parametrize("devices, groups", [
    (["cuda:0"] * 4, [("cuda:0", 0, 4)]),
    (["cuda:0", "cuda:1", "cuda:2", "cuda:3"], [("cuda:0", 0, 1), ("cuda:1", 1, 1), ("cuda:2", 2, 1),
                                                ("cuda:3", 3, 1)]),
    (["cuda:0", "cuda:0", "cuda:1", "cuda:1", "cuda:1"], [("cuda:0", 0, 2), ("cuda:1", 2, 3)]),
    (["cpu"] * 2, [("cpu", 0, 2)]),
])
def test_rank_groups_put_each_cards_ranks_together(devices, groups):
    got = [(str(g.device), g.first, g.count) for g in col.rank_groups(devices)]
    assert got == groups


def test_rank_groups_refuse_a_card_whose_ranks_are_apart():
    with pytest.raises(ValueError, match="not consecutive"):
        col.rank_groups(["cuda:0", "cuda:1", "cuda:0"])


def _fake(card: int, kind: int, i: int) -> int:
    """A fake address: card c's buffer of ``kind`` for its i-th rank."""
    return (card + 1) << 32 | kind << 16 | i << 8


def test_pointer_table_names_each_ranks_buffers_on_its_own_card():
    """Two cards of two ranks each: row ``kind``, column r of the table is
    rank r's buffer of that kind on rank r's card, so rank 1 (card 0)
    pushes into rank 2's landing planes on card 1 and writes its table rows
    into every rank's table on that rank's card."""
    cards = [(0, 0, 2), (1, 2, 2)]  # (card, first rank, ranks)
    ranks = [{kind: _fake(card, kind, i) for kind in range(col.NKIND) if kind != col.P_DATA}
             for card, _, m in cards for i in range(m)]
    rows = col.pointer_table(ranks)
    assert len(rows) == col.NKIND and all(len(row) == 4 for row in rows)
    for card, first, m in cards:
        for i in range(m):
            r = first + i
            for kind in range(col.NKIND):
                assert rows[kind][r] == (0 if kind == col.P_DATA else _fake(card, kind, i)), (r, kind)
    assert rows[col.P_H][2] == _fake(1, col.P_H, 0)  # rank 1's push from above lands on card 1
    assert rows[col.P_H][1] == _fake(0, col.P_H, 1)  # rank 2's push from below lands on card 0
    assert {rows[col.P_TABLE][r] >> 32 for r in range(4)} == {1, 2}
    assert {rows[col.P_CTR][r] >> 32 for r in range(4)} == {1, 2}


@pytest.mark.parametrize("method", ["cg", "cg1", "pipecg"])
def test_a_cards_scratch_gives_each_rank_its_own_rows(method):
    """``_Card``'s table rows for its ranks (here a card of three ranks laid
    out on the CPU): every state vector but x, the landing planes, the
    partials, the allreduce table and the counters, each rank's its own and
    16-byte aligned; the counters after the error word and the timers."""
    group = col.RankGroup(torch.device("cpu"), 4, 3)
    kinds = col.VECTORS[method][1:]
    card = col._Card(group, kinds, 99, torch.float64, 40, 12, 8, peer=False)
    rows = [card.addresses(i) for i in range(3)]
    assert all(set(r) == set(kinds) | {col.P_H, col.P_PARTS, col.P_TABLE, col.P_CTR} for r in rows)
    assert col.P_X not in rows[0] and col.P_B not in rows[0] and col.P_X0 not in rows[0]
    for kind in rows[0]:
        addresses = [r[kind] for r in rows]
        assert len(set(addresses)) == 3 and all(a % 16 == 0 for a in addresses if kind != col.P_CTR), kind
    base = card.words.data_ptr()
    assert [r[col.P_CTR] - base for r in rows] == [4 * (4 + 4 * 3 + i * col.NCTR) for i in range(3)]
    assert card.words.numel() == 4 + 4 * 3 + 3 * col.NCTR and card.zeroed is None


def _mesh_problem(seed: int = 2**31 + 5):
    bench = Bench()
    config = bench.config(bench.cell(CELL)["config"])
    traffic = {**bench.traffic(bench.cell(CELL)["traffic"]), "grid": list(GRID), "rhs": 2}
    return config, make_inputs(config, traffic, seed, "cpu")


@pytest.mark.parametrize("method", ["cg", "cg1"])
def test_collective_backend_on_four_cpu_ranks_follows_the_plain_reference(method):
    """``make_distributed_cg(backend="collective")`` on four CPU ranks of the
    cell's configuration, 8x6x4 a rank: the global 8x6x16 problem of the
    benchmark's plain reference. Twenty iterations (the tiny grids' depth
    in the benchmark's CPU tests): niters equal, the trace and x within
    1e-12 relative."""
    config, prob = _mesh_problem()
    mesh = make_mesh(4, devices=["cpu"] * 4)
    nx, ny, nz = GRID
    local = ProblemConfig(nx, ny, nz // 4, config["stencil"], prob.dtype)
    solve = make_distributed_cg(local, mesh, max_iter=20, tolerance=0.0, backend="collective", method=method)
    A = reference_matvec(config["reference"], prob, torch.float64, "cpu")
    for b in prob.rhs:
        res = solve(mesh.shard(b), mesh.shard(prob.x0))
        ref = reference_cg(A, b, prob.x0, max_iter=20)
        assert int(res.niters) == ref["niters"] == 19
        torch.testing.assert_close(res.trace, ref["trace"], rtol=1e-12, atol=0)
        torch.testing.assert_close(mesh.unshard(res.x), ref["x"], rtol=1e-12, atol=0)


def test_spans_and_counts_once_a_solve_when_tracing_is_on():
    """On: one ``collective.issue`` span a solve (on the CPU it holds the
    plain version, whose own solver spans lie inside it). The counts
    ``collective.wait_ns`` and ``collective.kernel_ns`` are the kernel's
    timers, so the CPU, where no kernel runs, records none (a card's are
    held by test_torch_cuda.py's
    test_collective_across_cards_reuses_its_set_up_and_times_its_waits). No
    ``collective.peer_setup`` on the CPU, where nothing is set up."""
    config, prob = _mesh_problem()
    mesh = make_mesh(4, devices=["cpu"] * 4)
    local = ProblemConfig(GRID[0], GRID[1], GRID[2] // 4, config["stencil"], prob.dtype)
    solve = make_distributed_cg(local, mesh, max_iter=10, backend="collective")
    bs, x0s = mesh.shard(prob.rhs[0]), mesh.shard(prob.x0)
    trace.enable()
    for _ in range(3):
        solve(bs, x0s)
    spans, counts = trace.take(), trace.take_counts()
    issue = [s for s in spans if s.name.startswith("collective.")]
    assert [s.name for s in issue] == ["collective.issue"] * 3
    inner = [s for s in spans if not s.name.startswith("collective.")]
    assert all(any(i.start <= s.start and s.end <= i.end for i in issue) for s in inner)
    assert counts == []


def test_off_records_nothing_and_reads_no_clock(monkeypatch):
    config, prob = _mesh_problem()
    mesh = make_mesh(4, devices=["cpu"] * 4)
    local = ProblemConfig(GRID[0], GRID[1], GRID[2] // 4, config["stencil"], prob.dtype)
    solve = make_distributed_cg(local, mesh, max_iter=10, backend="collective")

    def fail():
        raise AssertionError("a clock read with tracing off")

    monkeypatch.setattr(time, "perf_counter_ns", fail)
    monkeypatch.setattr(trace, "perf_counter_ns", fail)
    res = solve(mesh.shard(prob.rhs[0]), mesh.shard(prob.x0))
    assert int(res.niters) == 9
    assert trace.take() == [] and trace.take_counts() == []


def test_counts_stay_out_of_the_span_list():
    trace.enable()
    with trace.span("a"):
        trace.count("c", 1, 5)
    trace.count("c", 2, 7)
    assert [s.name for s in trace.take()] == ["a"]
    got = trace.take_counts()
    assert [(c.name, c.rank, c.value) for c in got] == [("c", 1, 5), ("c", 2, 7)]
    assert trace.take_counts() == []
    trace.disable()
    trace.count("c", 3, 9)
    assert trace.take_counts() == []
