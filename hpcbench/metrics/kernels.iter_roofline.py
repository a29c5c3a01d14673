"""kernels.iter_roofline (%): a CG iteration's least bytes
(``least_bytes_per_iter``) at the card's published HBM rate, over the
device's busy time per iteration in the traced stretch. On a cell of
``chips`` cards: the least bytes over ``chips`` cards' HBM rate, over the
mean of the cards' busy time per iteration (``Stretch.busy_s``).

Nothing to read off a card the peaks table does not list, or where an
iteration's least bytes per card are under four times one card's L2: the
state then stays in the cache, and the HBM rate bounds nothing."""

import json
from pathlib import Path

from hpcbench.metrics import least_bytes_per_iter

PEAKS = Path(__file__).resolve().parents[1] / "peaks.json"


def read(ctx):
    st = ctx.stretch
    if st is None or not st.cards_ran or not ctx.stretch_iters:
        return None
    peak = json.loads(PEAKS.read_text()).get(ctx.device_kind)
    if peak is None:
        return None
    p = ctx.problem
    least = least_bytes_per_iter(p.n, p.nnz, p.dtype.itemsize, ctx.explicit) / ctx.chips
    if least < 4 * peak["l2_bytes"]:
        return None
    busy_per_iter = st.busy_s / ctx.stretch_iters
    return 100.0 * (least / peak["hbm_bytes_per_s"]) / busy_per_iter
