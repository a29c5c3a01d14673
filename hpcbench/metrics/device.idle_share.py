"""device.idle_share (share): 1 - the union of a card's operations over
the traced stretch, from torch.profiler's trace, as a share of the
stretch; on several cards the mean over the cell's cards of each card's
idle share (a card that ran nothing reads 1)."""


def read(ctx):
    st = ctx.stretch
    if st is None or not st.cards_ran:
        return None
    shares = st.idle_shares()
    return sum(shares) / len(shares)
