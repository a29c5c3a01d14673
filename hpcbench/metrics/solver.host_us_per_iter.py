"""solver.host_us_per_iter (us/iter): the host's time issuing the CG
iterations' launches (the port's ``solver.issue`` spans, which leave out
the reads of the exit flag) over the iterations, in the traced run's
un-profiled stretch (``hpcbench.program_spans``)."""

from pathlib import Path

from hpcbench.program_spans import gather, total_s

CHECKS = Path(__file__).resolve().parents[1] / "checks"


def read(ctx):
    if not gather(ctx, CHECKS) or not ctx.loop_iters:
        return None
    return 1e6 * total_s(ctx.loop_spans, "solver.issue") / ctx.loop_iters
