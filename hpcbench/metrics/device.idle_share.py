"""device.idle_share (share): 1 - the union of the device's operations
over the traced stretch, from torch.profiler's trace."""

from hpcbench.metrics import idle_share


def read(ctx):
    st = ctx.stretch
    if st is None or not st.busy:
        return None
    return idle_share(st.busy, *st.window)
