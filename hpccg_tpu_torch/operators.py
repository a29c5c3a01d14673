"""Operators in plain torch (``hpccg_tpu.operators``).

- :class:`StencilOperator`, the implicit A of the generated problem. Every
  diagonal is 27 and every off-diagonal -1 (generate_matrix.cpp:268-274), so
  A @ x = 28*x - S(x), where S is the boundary-clipped neighbour sum
  including self. The matrix never materialises.
- :class:`EllMatrix`, the general explicit matrix in padded ELL, and
  :class:`DiaMatrix`, diagonal storage for banded matrices (the reference's
  CSR, HPC_Sparse_Matrix.hpp:56-66, in fixed-width layouts); an EllMatrix
  with ``start_row`` is a rank's row block, and :class:`DiaRows` a
  DiaMatrix's.

Each ``matvec`` here is the plain torch version: the CPU path, and what the
CUDA kernels are held against on the card (K1 for the stencil,
``ops/cuda/dia.py`` and ``ops/cuda/ell.py`` for DIA and ELL).

Vectors are flat (n,) tensors ordered row-major over (iz, iy, ix), the
reference's ``currow = iz*nx*ny + iy*nx + ix`` (generate_matrix.cpp:254), so
``x.view(nz, ny, nx)`` is free and exact.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from hpccg_tpu_torch.config import DIAG_VALUE, OFFDIAG_VALUE, Stencil


def stencil_offsets(stencil: Stencil):
    """(sz, sy, sx) offset triples in the reference's enumeration order
    (generate_matrix.cpp:259-261: sz outer, sy middle, sx inner)."""
    offs = [(sz, sy, sx) for sz in (-1, 0, 1) for sy in (-1, 0, 1) for sx in (-1, 0, 1)]
    if stencil == Stencil.S7:
        # ref generate_matrix.cpp:267 -- keep sz^2+sy^2+sx^2 <= 1
        offs = [o for o in offs if o[0] ** 2 + o[1] ** 2 + o[2] ** 2 <= 1]
    return offs


def _axis_sum3(u: torch.Tensor, dim: int) -> torch.Tensor:
    """v[i] = (u[i-1] + u[i]) + u[i+1] along ``dim``, zero beyond the ends.

    Same association as the JAX package's ``_axis_sum3``, so the f64 sums
    agree bit for bit."""
    n = u.shape[dim]
    s = u.clone()
    if n > 1:
        s.narrow(dim, 1, n - 1).add_(u.narrow(dim, 0, n - 1))
        s.narrow(dim, 0, n - 1).add_(u.narrow(dim, 1, n - 1))
    return s


def neighbor_sum_27(u: torch.Tensor) -> torch.Tensor:
    """Sum of u over the 3x3x3 neighbourhood (incl. self) of a (nz, ny, nx)
    grid, zero-clipped; separable: x, then y, then z."""
    return _axis_sum3(_axis_sum3(_axis_sum3(u, 2), 1), 0)


def neighbor_sum_7(u: torch.Tensor) -> torch.Tensor:
    """Sum of u over self + 6 face neighbours, zero beyond the boundaries."""
    s = u
    for dim in range(3):
        s = s + _axis_sum3(u, dim) - u
    return s


def neighbor_sum(u: torch.Tensor, stencil: Stencil) -> torch.Tensor:
    return neighbor_sum_27(u) if stencil == Stencil.S27 else neighbor_sum_7(u)


def apply_grid(u: torch.Tensor, stencil: Stencil) -> torch.Tensor:
    """A @ u on a (nz, ny, nx) grid: (DIAG - OFFDIAG)*u + OFFDIAG*S(u)."""
    s = neighbor_sum(u, stencil)
    return (DIAG_VALUE - OFFDIAG_VALUE) * u + OFFDIAG_VALUE * s


def _clip_counts(n: int):
    return [min(i + 1, 2) + min(n - i, 2) - 1 for i in range(n)]


@dataclasses.dataclass(frozen=True)
class StencilOperator:
    """Implicit A for the generated problem on an nx*ny*nz grid.

    Metadata only: the operator owns no tensors. ``nz`` is the local z-extent
    when used as one shard of a z-stacked global domain.
    """

    nx: int
    ny: int
    nz: int
    stencil: Stencil = Stencil.S27
    dtype: torch.dtype = torch.float64

    @property
    def local_nrow(self) -> int:
        return self.nx * self.ny * self.nz

    def grid(self, x: torch.Tensor) -> torch.Tensor:
        return x.view(self.nz, self.ny, self.nx)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """A @ x = 28*x - S(x); clipped neighbours contribute 0 to S, matching
        the reference's validity test (generate_matrix.cpp:266)."""
        return apply_grid(self.grid(x), self.stencil).reshape(-1)

    @property
    def nnz(self) -> int:
        """Exact local nonzero count (boundary-clipped)."""
        cx, cy, cz = (_clip_counts(n) for n in (self.nx, self.ny, self.nz))
        if self.stencil == Stencil.S27:
            return sum(cx) * sum(cy) * sum(cz)
        # 7-pt: self + up to 2 per axis
        ex, ey, ez = (sum(c - 1 for c in cs) for cs in (cx, cy, cz))
        return (
            self.local_nrow
            + ex * self.ny * self.nz
            + ey * self.nx * self.nz
            + ez * self.nx * self.ny
        )

    @property
    def nnz_model(self) -> int:
        """The reference's approximate count: stencil_size * nrow
        (generate_matrix.cpp:223,226 uses 27*nrow regardless of boundary)."""
        return self.stencil.value * self.local_nrow


def _host(t: torch.Tensor) -> np.ndarray:
    """t as a host numpy array; bfloat16 (which numpy lacks) widened exactly
    to float32."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _rows_of(nrow: int, width: int) -> np.ndarray:
    return np.broadcast_to(np.arange(nrow, dtype=np.int64)[:, None], (nrow, width))


def unique_offsets(offs: np.ndarray) -> np.ndarray:
    """np.unique of an int64 array of (col - row) offsets, by counting: the
    offsets lie within [-n, n], so a bincount over that range is O(nnz + n)
    where a sort is O(nnz log nnz)."""
    if offs.size == 0:
        return np.zeros((0,), np.int64)
    lo = int(offs.min())
    return np.flatnonzero(np.bincount(offs - lo)) + lo


# ---------------------------------------------------------------------------
# EllMatrix -- the general explicit path
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class EllMatrix:
    """Padded ELL: dense (nrow, width) vals / cols and a validity mask.

    The reference's jagged CSR (HPC_Sparse_Matrix.hpp:63-66) in a fixed-width
    layout: invalid slots carry val 0 and col 0, so the matvec needs no mask.
    ``cols`` are *global* int32 column ids; ``start_row`` / ``total_nrow`` are
    the partition metadata (HPC_Sparse_Matrix.hpp:56-62). The tensors may lie
    on any device; the readers keep them on the CPU (numpy's memory) while
    they analyse the structure.
    """

    vals: torch.Tensor  # (nrow, width) dtype
    cols: torch.Tensor  # (nrow, width) int32, global ids, 0 where invalid
    valid: torch.Tensor  # (nrow, width) bool
    start_row: int = 0
    total_nrow: Optional[int] = None

    @property
    def local_nrow(self) -> int:
        return self.vals.shape[0]

    @property
    def width(self) -> int:
        return self.vals.shape[1]

    @property
    def dtype(self) -> torch.dtype:
        return self.vals.dtype

    @property
    def device(self) -> torch.device:
        return self.vals.device

    @property
    def nnz(self) -> int:
        return int(self.valid.sum())

    def nnz_per_row(self) -> torch.Tensor:
        return self.valid.sum(dim=1, dtype=torch.int32)

    def local_cols(self) -> torch.Tensor:
        """Columns relative to this partition's row range."""
        return self.cols - self.start_row

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """y = A @ x, x indexed by *global* column ids (it covers
        [0, total_nrow)); invalid slots add 0 * x[0], as JAX's take does."""
        gathered = x.index_select(0, self.cols.reshape(-1)).view(self.cols.shape)
        return (self.vals * gathered).sum(dim=1)

    def to(self, device) -> "EllMatrix":
        return dataclasses.replace(self, vals=self.vals.to(device), cols=self.cols.to(device),
                                   valid=self.valid.to(device))

    def to_dense(self) -> torch.Tensor:
        """Dense (local_nrow, total_nrow) materialisation, tests only;
        duplicate (row, col) entries accumulate."""
        n = self.total_nrow if self.total_nrow is not None else self.local_nrow
        dense = torch.zeros((self.local_nrow, n), dtype=self.dtype, device=self.device)
        rows = torch.arange(self.local_nrow, device=self.device)[:, None].expand(self.cols.shape)
        return dense.index_put_((rows.reshape(-1), self.cols.reshape(-1).long()), self.vals.reshape(-1),
                                accumulate=True)

    def to_coo(self):
        """(rows, cols, vals) numpy triplets of the valid entries, row-major,
        entries within a row in storage order (the reference's CSR order,
        generate_matrix.cpp:259-276); rows are global. bfloat16 values come
        out as float32."""
        valid = _host(self.valid)
        rows = _rows_of(self.local_nrow, self.width)[valid]
        cols = _host(self.cols)[valid]
        vals = _host(self.vals)[valid]
        return rows + self.start_row, cols, vals

    def to_dia(self, max_diags: int = 128) -> Optional["DiaMatrix"]:
        """Diagonal storage if the matrix has at most ``max_diags`` distinct
        (col - row) offsets, else None. Also None for a row shard (the
        offsets would wrap) and for a matrix that stores explicit zeros: DIA
        treats them as structural, so a write round trip would lose them.
        Built on the host; the result lies on this matrix's device."""
        if self.start_row != 0:
            return None
        n = self.local_nrow
        if self.total_nrow is not None and self.total_nrow != n:
            return None
        rows, cols, vals = self.to_coo()
        if np.any(vals == 0):
            return None
        offs = cols.astype(np.int64) - rows
        uniq = unique_offsets(offs)
        if uniq.size > max_diags:
            return None
        didx = np.searchsorted(uniq, offs)
        data = np.zeros((uniq.size, n), dtype=vals.dtype)
        flat = didx * n + rows
        if rows.size and np.bincount(flat).max() > 1:
            np.add.at(data.reshape(-1), flat, vals)  # duplicates accumulate, as to_dense
        else:
            data.reshape(-1)[flat] = vals
        return DiaMatrix(data=torch.from_numpy(data).to(self.device, self.dtype),
                         offsets=tuple(int(o) for o in uniq), total_nrow=self.total_nrow or n)


# ---------------------------------------------------------------------------
# DiaMatrix -- banded explicit matrices, no gather
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DiaMatrix:
    """Diagonal storage: y[i] = sum_d data[d, i] * x[i + offsets[d]].

    ``data[d, r] = A[r, r + offsets[d]]``, zero where r + offsets[d] falls
    outside [0, n); ``offsets`` are static ints, strictly increasing. A
    stencil matrix has 27 (or 7) diagonals.
    """

    data: torch.Tensor  # (ndiag, nrow)
    offsets: tuple
    total_nrow: Optional[int] = None

    @property
    def local_nrow(self) -> int:
        return self.data.shape[1]

    @property
    def ndiag(self) -> int:
        return self.data.shape[0]

    @property
    def dtype(self) -> torch.dtype:
        return self.data.dtype

    @property
    def device(self) -> torch.device:
        return self.data.device

    @property
    def nnz(self) -> int:
        return int((self.data != 0).sum())

    def _span(self, off: int):
        """Rows [lo, hi) on which diagonal ``off`` lies inside the matrix."""
        n = self.local_nrow
        return max(0, -off), min(n, n - off)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """y = A @ x: one sliced multiply-add per diagonal, in offset order
        (the order of the DIA kernel's sum)."""
        y = torch.zeros((self.local_nrow,), dtype=torch.promote_types(self.dtype, x.dtype), device=x.device)
        for d, off in enumerate(self.offsets):
            lo, hi = self._span(off)
            if hi > lo:
                y[lo:hi] += self.data[d, lo:hi] * x[lo + off : hi + off]
        return y

    def to(self, device) -> "DiaMatrix":
        return dataclasses.replace(self, data=self.data.to(device))

    def to_coo(self):
        """(rows, cols, vals) numpy triplets of the stored nonzeros,
        row-major, within a row by column (= offset order); bfloat16 values
        come out as float32."""
        data = _host(self.data)
        rs, cs, vs = [np.zeros((0,), np.int64)], [np.zeros((0,), np.int64)], [data[:0, 0]]
        for d, off in enumerate(self.offsets):
            lo, hi = self._span(off)
            rows = np.arange(lo, max(lo, hi), dtype=np.int64)
            v = data[d, rows]
            keep = v != 0
            rs.append(rows[keep])
            cs.append(rows[keep] + off)
            vs.append(v[keep])
        rows, cols, vals = np.concatenate(rs), np.concatenate(cs), np.concatenate(vs)
        order = np.lexsort((cols, rows))
        return rows[order], cols[order], vals[order]

    def nnz_per_row(self) -> torch.Tensor:
        counts = torch.zeros((self.local_nrow,), dtype=torch.int32, device=self.device)
        for d, off in enumerate(self.offsets):
            lo, hi = self._span(off)
            if hi > lo:
                counts[lo:hi] += (self.data[d, lo:hi] != 0).to(torch.int32)
        return counts

    def to_ell(self) -> EllMatrix:
        """Padded-ELL view of the stored nonzeros, on this matrix's device."""
        rows, cols, vals = self.to_coo()
        n = self.local_nrow
        counts = np.bincount(rows, minlength=n)
        width = max(int(counts.max()) if n else 0, 1)
        ev = np.zeros((n, width), vals.dtype)
        ec = np.zeros((n, width), np.int32)
        em = np.zeros((n, width), bool)
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        slot = np.arange(len(rows)) - starts[rows]
        ev[rows, slot] = vals
        ec[rows, slot] = cols
        em[rows, slot] = True
        return EllMatrix(vals=torch.from_numpy(ev).to(self.dtype), cols=torch.from_numpy(ec),
                         valid=torch.from_numpy(em), start_row=0, total_nrow=self.total_nrow or n).to(self.device)

    def to_dense(self) -> torch.Tensor:
        """Dense materialisation, tests only."""
        n = self.local_nrow
        dense = torch.zeros((n, n), dtype=self.dtype, device=self.device)
        for d, off in enumerate(self.offsets):
            lo, hi = self._span(off)
            if hi > lo:
                r = torch.arange(lo, hi, device=self.device)
                dense[r, r + off] = self.data[d, lo:hi]
        return dense


def band(offsets) -> tuple:
    """(bw_lo, bw_hi): how far a DIA band reaches below and above the
    diagonal (the extreme negative and positive offsets, 0 if none)."""
    offs = tuple(offsets)
    return (max(0, -min(offs)), max(0, max(offs))) if offs else (0, 0)


@dataclasses.dataclass(frozen=True)
class DiaRows:
    """Rows [start_row, start_row + L) of a DiaMatrix: one rank's row block
    (``parallel.cg.shard_problem``). ``data`` (ndiag, L) is the matrix's
    data over those rows. Row i reads the rank's extended vector
    x_ext = [bw_lo rows below | its L rows | bw_hi rows above]
    (``parallel.halo.BandStrips``, zero beyond the global ends):
    y[i] = sum_d data[d, i] * x_ext[i + bw_lo + offsets[d]]."""

    data: torch.Tensor  # (ndiag, L)
    offsets: tuple
    start_row: int
    total_nrow: int

    @property
    def local_nrow(self) -> int:
        return self.data.shape[1]

    @property
    def ndiag(self) -> int:
        return self.data.shape[0]

    @property
    def dtype(self) -> torch.dtype:
        return self.data.dtype

    @property
    def device(self) -> torch.device:
        return self.data.device

    @property
    def bw_lo(self) -> int:
        return band(self.offsets)[0]

    @property
    def bw_hi(self) -> int:
        return band(self.offsets)[1]

    def matvec(self, x_ext: torch.Tensor) -> torch.Tensor:
        """y = A[rows] @ x from the extended vector: one sliced multiply-add
        per diagonal, in offset order (the DIA kernel's order and
        roundings). Every term is added, the zero fill beyond the global
        ends included."""
        L, lo = self.local_nrow, self.bw_lo
        y = torch.zeros((L,), dtype=torch.promote_types(self.dtype, x_ext.dtype), device=x_ext.device)
        for d, off in enumerate(self.offsets):
            y += self.data[d] * x_ext[lo + off : lo + off + L]
        return y
