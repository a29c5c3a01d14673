"""gnnz_per_s (Gnnz/s): the matrix's stored nonzeros times the iterations
of every solve completed in the window, over the time from the window's
start to the last completion."""

from hpcbench.metrics import finite


def read(ctx):
    if not ctx.iters or not ctx.window_s:
        return None
    return finite(ctx.problem.nnz * sum(ctx.iters) / ctx.window_s / 1e9)
