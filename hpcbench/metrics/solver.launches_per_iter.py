"""solver.launches_per_iter (launches/iter): the kernels the device ran in
the traced stretch over the CG iterations of its solves; on several cards,
every card's kernels (what the host issues) over the iterations."""


def read(ctx):
    st = ctx.stretch
    if st is None or not st.kernels or not ctx.stretch_iters:
        return None
    return st.kernels / ctx.stretch_iters
