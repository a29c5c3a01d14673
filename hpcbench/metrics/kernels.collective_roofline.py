"""kernels.collective_roofline (%): the collective whole-solve kernel's
(K15/K16, ``collective_kernel``) share of its roofline in the traced
stretch. The floor is an iteration's least bytes (``least_bytes_per_iter``:
x, r and p read and written once) divided among the cell's ``chips`` cards,
at one card's published HBM rate; the time is the kernel's own device time
(its ``device_ops`` seconds, summed over the cards) per card per CG
iteration. It is a bytes floor even where each card's state fits in its L2
(64^3 float64 a card: 12.58 MB, 3.76 us at 3.35 TB/s), so it stays far
below 100% where an iteration waits on cross-card allreduces. Nothing to
read off a card that the peaks table does not list, or where the trace
holds no such kernel."""

import json
from pathlib import Path

from hpcbench.metrics import least_bytes_per_iter

PEAKS = Path(__file__).resolve().parents[1] / "peaks.json"
KERNEL = "collective_kernel<"


def read(ctx):
    st = ctx.stretch
    if st is None or not ctx.stretch_iters:
        return None
    peak = json.loads(PEAKS.read_text()).get(ctx.device_kind)
    seconds = sum(s for name, s in st.device_ops if KERNEL in name)
    if peak is None or seconds <= 0:
        return None
    p = ctx.problem
    least = least_bytes_per_iter(p.n, p.nnz, p.dtype.itemsize, ctx.explicit) / ctx.chips
    per_iter = seconds / ctx.chips / ctx.stretch_iters
    return 100.0 * (least / peak["hbm_bytes_per_s"]) / per_iter
