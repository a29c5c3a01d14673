"""How far two bf16 collective solves part when only their sums' order differs, on the CPU.

    python3 scripts/bf16_pipecg_sum_order.py

Runs the plain bf16 K15/K16 (``ops.cuda.collective.solve_plain``: bf16
vectors, float32 scalars) twice on the same problem: once as it is, once
with every dot product summed in float64 and rounded to float32, which
stands for another summation order (the kernel's block tree). For cg, cg1
and pipecg it prints the first iteration k where the traces part by more
than 1.5e-2, the largest part over k <= 7, the share of x's elements that
differ, and the true residual ||b - A x|| / ||b|| of both. These readings
set the bf16 limits in ``chip_smoke.py`` (PIPE_BF16_HEAD,
BF16_MAIN_FLOOR). Four CPU threads, so that torch's own sums keep one
order.
"""

from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from hpccg_tpu_torch import ProblemConfig  # noqa: E402
from hpccg_tpu_torch.ops.cuda import collective as col  # noqa: E402
from hpccg_tpu_torch.parallel import generate_problem_sharded, make_mesh  # noqa: E402
from hpccg_tpu_torch.parallel.cg import local_operator  # noqa: E402
from hpccg_tpu_torch.parallel.halo import stencil_matvec_halo  # noqa: E402

# (ranks, per-rank block, iterations, methods)
CASES = [(1, (33, 17, 9), 30, ("cg", "cg1", "pipecg")), (2, (33, 17, 9), 30, ("cg", "cg1", "pipecg")),
         (8, (33, 17, 9), 30, ("cg", "cg1", "pipecg")), (1, (64, 48, 13), 30, ("cg", "cg1", "pipecg")),
         (1, (64, 64, 64), 50, ("cg", "cg1", "pipecg")), (8, (128, 64, 16), 8, ("pipecg",))]


def _dot64(u, v, _dot=torch.dot):
    return _dot(u.double(), v.double()).float()


def _true_residual(op, bs, xs) -> float:
    ax = stencil_matvec_halo(dataclasses.replace(op, dtype=torch.float64), tuple(v.double() for v in xs))
    r = torch.cat([b.double() - y for b, y in zip(bs, ax)])
    return float(r.norm() / torch.cat([b.double() for b in bs]).norm())


def main() -> int:
    torch.set_num_threads(4)
    for ndev, dims, iters, methods in CASES:
        cfg = ProblemConfig(*dims, dtype=torch.bfloat16)
        op, prob = local_operator(cfg), generate_problem_sharded(cfg, make_mesh(ndev, devices=["cpu"] * ndev))
        for method in methods:
            a = col.solve_plain(op, prob.b, prob.x0, method=method, max_iter=iters)
            dot, torch.dot = torch.dot, _dot64
            try:
                b = col.solve_plain(op, prob.b, prob.x0, method=method, max_iter=iters)
            finally:
                torch.dot = dot
            ta, tb = a.trace.double(), b.trace.double()
            rel = (ta - tb).abs() / ta
            over = torch.nonzero(rel > 1.5e-2)
            where = f"k = {int(over[0])}, at {float(ta[over[0]] / ta[0]):.1e} of trace[0]" if over.numel() else "none"
            xa, xb = torch.cat(a.x), torch.cat(b.x)
            print(f"{ndev} x {dims} {method}, {iters} iterations: first part over 1.5e-2 {where}; "
                  f"largest part over k <= 7 {float(rel[:8].max()):.1e}; "
                  f"x differs in {float((xa != xb).double().mean()):.2f} of the elements; true residual "
                  f"{_true_residual(op, prob.b, a.x):.3e} / {_true_residual(op, prob.b, b.x):.3e}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
