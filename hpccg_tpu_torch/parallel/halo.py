"""Halo exchange and the halo'd matvecs (ref exchange_externals.cpp:51-131;
``hpccg_tpu.parallel.halo``), over a sharded vector.

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

For an explicit banded matrix with its rows block-sharded (distributed file
mode, ``parallel.cg``) the halo is band strips instead: rank r reads the
last bw_lo rows of rank r-1 and the first bw_hi rows of rank r+1, where
bw_lo / bw_hi is how far the band reaches below / above the diagonal (the
JAX package moves them with ppermute, ``hpccg_tpu/parallel/cg.py:1209``).

- :class:`BandStrips`: per-rank extended vectors [bw_lo | L | bw_hi],
  allocated once and refilled before each apply; zero at the global ends.
"""

from __future__ import annotations

from typing import Optional

import torch

from hpccg_tpu_torch.operators import StencilOperator, apply_grid
from hpccg_tpu_torch.ops.cuda.stencil import spmv_stencil, spmv_stencil_pap, spmv_stencil_pap_dd


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
    stencil on each rank, flat shards in and out, in the vectors' dtype
    (all-bf16 for bf16, as the single-device ``stencil`` backend)."""
    grids = [op.grid(v) for v in vs]
    out = []
    for u, (below, above) in zip(grids, exchange_halo(grids)):
        ext = torch.cat([below.unsqueeze(0), u, above.unsqueeze(0)], 0)
        out.append(apply_grid(ext, op.stencil)[1:-1].reshape(-1))
    return tuple(out)


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


class BandStrips:
    """Each rank's extended vector x_ext = [bw_lo rows of the rank below |
    its own L rows | bw_hi rows of the rank above], the x that the windowed
    DIA kernel (K9/K10 on ``DiaRows``) and the ell-halo tier's K11/K12 read.
    The buffers are allocated once; ``fill`` copies a sharded vector into
    them before each apply. Both strips stay zero at the global ends (the
    band's clipping). The band must fit one shard (bw_lo, bw_hi <= L)."""

    def __init__(self, L: int, bw_lo: int, bw_hi: int, devices, dtype):
        if bw_lo > L or bw_hi > L:
            raise ValueError(f"a band of {bw_lo}/{bw_hi} rows does not fit {L}-row shards")
        self.L, self.bw_lo, self.bw_hi = L, bw_lo, bw_hi
        self.ext = [torch.zeros((bw_lo + L + bw_hi,), dtype=dtype, device=d) for d in devices]

    def fill(self, vs) -> list:
        """The extended vectors of the sharded vector ``vs``."""
        L, lo, hi, n = self.L, self.bw_lo, self.bw_hi, len(self.ext)
        for r, ext in enumerate(self.ext):
            ext[lo : lo + L].copy_(vs[r])
            if lo and r > 0:
                ext[:lo].copy_(vs[r - 1][L - lo :])
            if hi and r < n - 1:
                ext[lo + L :].copy_(vs[r + 1][:hi])
        return self.ext
