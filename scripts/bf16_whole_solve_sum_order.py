"""How a tolerance-0 bf16 whole solve ends (it stagnates and runs to
max_iter, or r.r flushes to 0 and it exits early) against the way its dot
products are summed, on the CPU.

    python3 scripts/bf16_whole_solve_sum_order.py [N] [MAX_ITER]

Runs the plain K5 (``megakernel``) and K6 (``streamkernel``) whole solves
of ``ops/cuda/wholesolve.py`` on the N^3 27-point problem (default 32, the
grid of ``tests/test_torch_wholesolve.py::test_bf16_niters_exact_past_256``)
in bfloat16 for MAX_ITER iterations (default 300), once with each of
these sums of u.v (products in float32), and prints the niters of each:

- ``plane_dot``: the port's (each z-plane's products added in float64 and
  rounded to float32 once, the plane sums added in float32 in z order);
- ``torch.dot`` and ``(u * v).sum()`` in float32;
- one exact sum of the whole vector, of the products rounded to float32
  and of the exact products (float64 sums, rounded once);
- slabs of 8 and 32 planes (the plane form with wider slabs);
- float32 sums over a random order of the terms (three seeds).

The JAX kernels run this solve to 299 at 32^3. Takes about 2 minutes.
"""

from __future__ import annotations

import os
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from hpccg_tpu_torch import ProblemConfig, generate_problem  # noqa: E402
from hpccg_tpu_torch.ops.cuda import wholesolve as ws  # noqa: E402


def slabs(width):
    def dot(u, v, nz, sdt):
        planes = (u.to(sdt) * v.to(sdt)).to(torch.float64).reshape(nz, -1).sum(1)
        acc = torch.zeros((), dtype=sdt)
        for s in range(0, nz, width):
            acc = acc + planes[s:s + width].sum().to(sdt)
        return acc.reshape(1)
    return dot


def permuted(seed):
    perm = {}

    def dot(u, v, nz, sdt):
        if u.numel() not in perm:
            perm[u.numel()] = torch.randperm(u.numel(), generator=torch.Generator().manual_seed(seed))
        return (u.to(sdt) * v.to(sdt))[perm[u.numel()]].reshape(-1, 64).sum(1).sum().reshape(1)
    return dot


SUMS = {
    "plane_dot (the port's)": ws.plane_dot,
    "torch.dot": lambda u, v, nz, sdt: torch.dot(u.to(sdt), v.to(sdt)).reshape(1),
    "(u * v).sum()": lambda u, v, nz, sdt: (u.to(sdt) * v.to(sdt)).sum().reshape(1),
    "exact sum, products rounded": lambda u, v, nz, sdt: (u.to(sdt) * v.to(sdt)).double().sum().to(sdt).reshape(1),
    "exact sum, exact products": lambda u, v, nz, sdt: (u.double() * v.double()).sum().to(sdt).reshape(1),
    "slabs of 8 planes": slabs(8),
    "slabs of 32 planes": slabs(32),
    **{f"float32, random order (seed {s})": permuted(s) for s in range(3)},
}


def main(argv) -> int:
    n = int(argv[0]) if argv else 32
    max_iter = int(argv[1]) if len(argv) > 1 else 300
    prob = generate_problem(ProblemConfig(n, n, n, dtype=torch.bfloat16), "cpu")
    port_dot = ws.plane_dot
    try:
        for name, dot in SUMS.items():
            ws.plane_dot = dot
            out = [int(ws.solve_plain(prob.A, prob.b, prob.x0, max_iter=max_iter, tolerance=0.0,
                                      recompute_ap=rap).niters) for rap in (False, True)]
            print(f"{n}^3 bf16, {max_iter} iterations, {name}: K5 niters {out[0]}, K6 niters {out[1]}", flush=True)
    finally:
        ws.plane_dot = port_dot
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
