"""collective.issue_us_per_solve (us/solve): the host's time issuing every
card's launch of the collective kernels (the port's ``collective.issue``
spans: allocating x and the trace, the pointer tables' copies, zeroing the
counters, the launches) over the solves of the traced run's un-profiled
stretch (``hpcbench.program_spans``). Nothing to read where the port has no
such span."""

from pathlib import Path

from hpcbench.program_spans import count, gather, total_s

CHECKS = Path(__file__).resolve().parents[1] / "checks"
SPAN = "collective.issue"


def read(ctx):
    if not gather(ctx, CHECKS) or not count(ctx.loop_spans, SPAN):
        return None
    return 1e6 * total_s(ctx.loop_spans, SPAN) / int(ctx.traffic["trace_solves"])
