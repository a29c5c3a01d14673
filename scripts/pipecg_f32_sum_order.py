"""How far two float32 pipelined CG solves part when only their sums' order differs, on the CPU.

    python3 scripts/pipecg_f32_sum_order.py [--device cuda]

Runs the plain K16 (``ops.cuda.collective.solve_plain``, method pipecg:
float32 vectors and scalars) five times on the same problem, with every
dot product summed in another order: torch.dot as it is; in float64,
rounded to float32 once; in K16's own form (each z-plane's products added
in float64 and rounded to float32, the plane sums added in float32 in z
order, ``wholesolve.plane_dot``); torch.dot over the reversed vectors; and
float32 sums of 4096-element chunks added in float32 in order (a block
tree's shape). chip_smoke.py holds K16 against the
first of them over 30 iterations, the trace within 1e-2 above 1e-4 of
trace[0] (PIPE_TRACE). For each case the script prints, for each pair of
orders, the largest relative part of the traces above that floor, the
iteration where it lies, and max|x_a - x_b| / max|x_b|. Four CPU threads,
so that torch's own sums keep one order. With ``--device cuda`` every rank
lies on the one card (torch.dot is then the card's own order), and K16
itself is held against each plain order too, at the first case only.
"""

from __future__ import annotations

import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from hpccg_tpu_torch import ProblemConfig  # noqa: E402
from hpccg_tpu_torch.ops.cuda import collective as col  # noqa: E402
from hpccg_tpu_torch.ops.cuda.wholesolve import plane_dot  # noqa: E402
from hpccg_tpu_torch.parallel import generate_problem_sharded, make_mesh  # noqa: E402
from hpccg_tpu_torch.parallel.cg import local_operator  # noqa: E402

ITERS, FLOOR = 30, 1e-4  # chip_smoke.COLL_ITERS and PIPE_TRACE's float32 floor
# (ranks, per-rank block): the case chip_smoke left out, and two it keeps
CASES = [(2, (128, 512, 16)), (8, (64, 400, 9)), (2, (128, 64, 16))]


def _chunked(u, v, chunk=4096):
    """u . v as float32 sums of chunk-element pieces, added in float32 in order."""
    parts = torch.nn.functional.pad(u * v, (0, -u.numel() % chunk)).reshape(-1, chunk).sum(1)
    acc = torch.zeros((), dtype=u.dtype, device=u.device)
    for t in parts:
        acc = acc + t
    return acc


def _solve(op, prob, dot):
    saved = torch.dot
    torch.dot = dot
    try:
        return col.solve_plain(op, prob.b, prob.x0, method="pipecg", max_iter=ITERS)
    finally:
        torch.dot = saved


def main(argv) -> int:
    device = argv[argv.index("--device") + 1] if "--device" in argv else "cpu"
    torch.set_num_threads(4)
    torch_dot = torch.dot
    for ndev, dims in CASES[:1] if device == "cuda" else CASES:
        cfg = ProblemConfig(*dims, dtype=torch.float32)
        op, prob = local_operator(cfg), generate_problem_sharded(cfg, make_mesh(ndev, devices=[device] * ndev))
        orders = {
            "torch.dot": torch_dot,
            "float64": lambda u, v: torch_dot(u.double(), v.double()).float(),
            "per plane": lambda u, v: plane_dot(u, v, dims[2], torch.float32).reshape(()),
            "reversed": lambda u, v: torch_dot(u.flip(0), v.flip(0)),
            "4096-chunks": _chunked,
        }
        runs = {name: _solve(op, prob, dot) for name, dot in orders.items()}
        if device == "cuda":
            runs = {"K16": col.cg_collective_pipelined(op, prob.b, prob.x0, max_iter=ITERS), **runs}
        names = list(runs)
        for i, a in enumerate(names):
            for b in names[i + 1:]:
                ta, tb = runs[a].trace.double(), runs[b].trace.double()
                head = tb > FLOOR * tb[0]
                rel = torch.where(head, (ta - tb).abs() / tb, torch.zeros_like(tb))
                k = int(rel.argmax())
                xa, xb = torch.cat(runs[a].x), torch.cat(runs[b].x)
                xrel = float((xa - xb).abs().max() / xb.abs().max())
                print(f"{ndev} x {dims[0]}x{dims[1]}x{dims[2]} pipecg f32, {ITERS} iterations, {a} vs {b}: trace "
                      f"{float(rel.max()):.3e} at k = {k} ({float(tb[k] / tb[0]):.1e} of trace[0]); x {xrel:.3e}",
                      flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
