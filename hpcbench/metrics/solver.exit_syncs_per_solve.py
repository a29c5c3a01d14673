"""solver.exit_syncs_per_solve (reads/solve): the host's blocking reads of
the exit flag (the port's ``solver.exit_read`` spans) over its solves
(``solver.solve``), in the traced run's un-profiled stretch
(``hpcbench.program_spans``)."""

from pathlib import Path

from hpcbench.program_spans import count, gather

CHECKS = Path(__file__).resolve().parents[1] / "checks"


def read(ctx):
    if not gather(ctx, CHECKS):
        return None
    solves = count(ctx.loop_spans, "solver.solve")
    return count(ctx.loop_spans, "solver.exit_read") / solves if solves else None
