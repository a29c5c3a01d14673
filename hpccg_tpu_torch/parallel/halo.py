"""Halo exchange and the halo'd stencil matvecs (ref exchange_externals.cpp:
51-131; ``hpccg_tpu.parallel.halo``), over a sharded vector.

For the z-stacked stencil problem each rank exchanges exactly its first and
last nx*ny plane with at most two neighbours. On the single-controller mesh
(``parallel.mesh``) the exchange is a copy of the neighbour's plane onto the
rank's device; the planes are zero at the global ends, which is the
stencil's boundary clipping.

- ``exchange_halo`` / ``stencil_matvec_halo``: plain torch (the ``stencil``
  backend and the plain versions of the kernels).
- :class:`HaloPlanes`: per-rank (2 or 4, ny, nx) buffers that the kernels
  take as their external halo input, refilled before each apply; None on a
  one-rank mesh (the kernels' domain boundary).
- ``kernel_matvec`` / ``kernel_matvec_pap``: K1, K2 or K7 on each rank with
  its two planes; K3 takes four (``solver.cg_solve_fused``).
"""

from __future__ import annotations

from typing import Optional

import torch

from hpccg_tpu_torch.operators import StencilOperator
from hpccg_tpu_torch.ops.cuda.stencil import (
    spmv_stencil,
    spmv_stencil_pap,
    spmv_stencil_pap_dd,
    spmv_stencil_plain,
)


def exchange_halo(grids) -> list:
    """(below, above) for each rank's (nz, ny, nx) block: the neighbours'
    adjacent planes on the rank's device, zeros at the global ends."""
    n = len(grids)
    out = []
    for i, u in enumerate(grids):
        below = grids[i - 1][-1].to(u.device) if i > 0 else torch.zeros_like(u[0])
        above = grids[i + 1][0].to(u.device) if i < n - 1 else torch.zeros_like(u[0])
        out.append((below, above))
    return out


def stencil_matvec_halo(op: StencilOperator, vs) -> tuple:
    """Distributed A v (``op`` holds one rank's dims): the plain halo'd
    stencil on each rank, flat shards in and out."""
    grids = [op.grid(v) for v in vs]
    return tuple(spmv_stencil_plain(op, u, torch.stack(h)).reshape(-1) for u, h in zip(grids, exchange_halo(grids)))


class HaloPlanes:
    """Each rank's external z-planes as the kernels take them: (2, ny, nx)
    [below, above] of one vector, or (4, ny, nx) [r below, r above, p below,
    p above] for K3. The buffers are allocated once; the global ends stay
    zero."""

    def __init__(self, op: StencilOperator, devices, dtype):
        self.op = op
        self.n = len(devices)
        self.two = [torch.zeros((2, op.ny, op.nx), dtype=dtype, device=d) for d in devices]
        self.four = [torch.zeros((4, op.ny, op.nx), dtype=dtype, device=d) for d in devices]

    def _fill(self, bufs, vs, first: int) -> None:
        g = self.op.grid
        for i in range(self.n):
            if i > 0:
                bufs[i][first].copy_(g(vs[i - 1])[-1])
            if i < self.n - 1:
                bufs[i][first + 1].copy_(g(vs[i + 1])[0])

    def planes2(self, vs) -> list:
        if self.n == 1:
            return [None]
        self._fill(self.two, vs, 0)
        return self.two

    def planes4(self, rs, ps) -> list:
        if self.n == 1:
            return [None]
        self._fill(self.four, rs, 0)
        self._fill(self.four, ps, 2)
        return self.four


def kernel_matvec(op: StencilOperator, halo: HaloPlanes, vs, outs: Optional[tuple] = None) -> tuple:
    """A v with K1 on each rank (its plain version on the CPU)."""
    g = op.grid
    outs = outs or tuple(torch.empty_like(v) for v in vs)
    for v, h, out in zip(vs, halo.planes2(vs), outs):
        spmv_stencil(op, g(v), h, out=g(out))
    return outs


def kernel_matvec_pap(op: StencilOperator, halo: HaloPlanes, vs, outs, partials, active, dd: bool = False):
    """A v into ``outs`` with K2 (K7 when ``dd``) on each rank, the ranks'
    p.Ap partials into ``partials`` (a ``solver.RankPartials``); returns
    the partials gathered in rank order."""
    g = op.grid
    k2 = spmv_stencil_pap_dd if dd else spmv_stencil_pap
    for i, (v, h, out) in enumerate(zip(vs, halo.planes2(vs), outs)):
        k2(op, g(v), h, out=g(out), partials=partials.parts[i], active=active.to(v.device))
    return partials.gather()
