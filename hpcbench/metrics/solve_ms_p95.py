"""solve_ms_p95 (ms): the 95th percentile of the time of every solve in
the window, from the call until its result is on the host."""

from hpcbench.metrics import p95


def read(ctx):
    return p95(ctx.times) * 1e3 if ctx.times else None
