"""Bandwidth-reducing reordering and the structure chooser
(``hpccg_tpu.reorder``).

CG is basis-invariant, so a matrix that is a banded matrix under a
permutation can be solved in the permuted basis:

    solve (P A P^T) y = P b   ==>   x = P^T y

with the two vector permutations done once on the host, never inside the
iteration. ``rcm_permutation`` computes the reverse Cuthill-McKee order
(scipy's csgraph implementation, with a NumPy BFS fallback);
``auto_structure`` picks the representation an explicit matrix solves in on
Hopper: DIA (kernel K9/K10) or ELL (the gather kernel K11/K12).

This module owns every reverse Cuthill-McKee decision. Where the caller
allows a change of basis (the CLI's file mode, ``auto_structure``), the
matrix is permuted once. Where it does not (``make_cg`` on a matrix as
loaded, ``--no-reorder``), ``relabel_order`` says whether the ELL kernel
should gather in RCM order all the same: K13's kernel relabels x at each
launch and stores each row's sum back at its row, so the solve keeps its
basis and K11's bits (``ops/cuda/ell.py``).

The JAX package's chooser weighs TPU cost models (the DIA slot rate, the
gather-window fit, the strip-stack and dynamic-window models) that describe
a chip without a hardware gather; they are not ported. Hopper gathers
natively, so the rule here is the bytes one SpMV streams (see
:func:`auto_structure`). Structure analysis runs on host numpy arrays; only
the representation that solves goes to the device. With the port's tracing
on (``utils.trace``), ``auto_structure`` and its steps (``reorder.band``,
``reorder.to_dia``, ``reorder.rcm``, ``reorder.permute``) record spans.
"""

from __future__ import annotations

import dataclasses
import math
import weakref
from typing import Optional, Tuple

import numpy as np
import torch

from hpccg_tpu_torch.operators import EllMatrix, unique_offsets
from hpccg_tpu_torch.utils import trace


def _rcm_numpy(indptr: np.ndarray, indices: np.ndarray, n: int) -> np.ndarray:
    """Reverse Cuthill-McKee by plain BFS with degree-sorted tie-breaking
    (the fallback when scipy is missing)."""
    degrees = np.diff(indptr)
    visited = np.zeros(n, dtype=bool)
    order = np.empty(n, dtype=np.int64)
    pos = 0
    for seed in np.argsort(degrees, kind="stable"):
        if visited[seed]:
            continue
        visited[seed] = True
        order[pos] = seed
        head, pos = pos, pos + 1
        while head < pos:
            u = order[head]
            head += 1
            nbrs = indices[indptr[u] : indptr[u + 1]]
            nbrs = nbrs[~visited[nbrs]]
            if nbrs.size:
                nbrs = np.unique(nbrs)
                nbrs = nbrs[np.argsort(degrees[nbrs], kind="stable")]
                visited[nbrs] = True
                order[pos : pos + nbrs.size] = nbrs
                pos += nbrs.size
    return order[::-1].copy()


@trace.spanned("reorder.rcm")
def rcm_permutation(A: EllMatrix) -> np.ndarray:
    """perm such that B = A[perm][:, perm] has (near-)minimal bandwidth:
    new row i is old row perm[i]."""
    if A.start_row != 0 or (A.total_nrow or A.local_nrow) != A.local_nrow:
        raise ValueError("rcm_permutation needs the assembled square matrix")
    n = A.local_nrow
    rows, cols, _ = A.to_coo()
    try:
        from scipy.sparse import csr_matrix
        from scipy.sparse.csgraph import reverse_cuthill_mckee
    except ImportError:
        sym_rows, sym_cols = np.r_[rows, cols], np.r_[cols, rows]
        order = np.lexsort((sym_cols, sym_rows))
        sym_rows, sym_cols = sym_rows[order], sym_cols[order]
        indptr = np.searchsorted(sym_rows, np.arange(n + 1))
        return _rcm_numpy(indptr, sym_cols, n)
    sym = csr_matrix((np.ones(2 * len(rows)), (np.r_[rows, cols], np.r_[cols, rows])), shape=(n, n))
    return np.ascontiguousarray(reverse_cuthill_mckee(sym, symmetric_mode=True), dtype=np.int64)


@trace.spanned("reorder.permute")
def permute_ell(A: EllMatrix, perm: np.ndarray) -> EllMatrix:
    """B = P A P^T in ELL form, B[i, j] = A[perm[i], perm[j]], on the host
    (CPU tensors over numpy arrays)."""
    n = A.local_nrow
    perm = np.ascontiguousarray(perm, dtype=np.int64)
    inv = np.empty(n, dtype=np.int64)
    inv[perm] = np.arange(n)
    valid = A.valid.cpu().numpy()[perm]
    cols = np.where(valid, inv[A.cols.cpu().numpy()[perm]], 0).astype(np.int32)
    return EllMatrix(vals=A.vals.cpu()[torch.from_numpy(perm)], cols=torch.from_numpy(cols),
                     valid=torch.from_numpy(valid), start_row=0, total_nrow=A.total_nrow)


def bandwidth(A: EllMatrix) -> int:
    """max |col - row| over the stored entries."""
    rows, cols, _ = A.to_coo()
    if len(rows) == 0:
        return 0
    return int(np.max(np.abs(cols.astype(np.int64) - rows)))


@dataclasses.dataclass(frozen=True)
class StructureReport:
    """What auto_structure decided and why (for logs and reports)."""

    format: str  # "dia" | "dia+rcm" | "ell" | "ell+rcm"
    ndiag: Optional[int]
    bandwidth_before: int
    bandwidth_after: Optional[int]
    inflation: Optional[float]  # stored diagonal slots / true nnz
    reason: str


@dataclasses.dataclass(frozen=True)
class _Band:
    """One basis's band statistics, from one to_coo pass."""

    bandwidth: int
    ndiag: int
    stored_zeros: bool


@trace.spanned("reorder.band")
def _band(A: EllMatrix) -> _Band:
    rows, cols, vals = A.to_coo()
    offs = cols.astype(np.int64) - rows
    bw = int(np.abs(offs).max()) if offs.size else 0
    return _Band(bw, int(unique_offsets(offs).size), bool(np.any(vals == 0)))


STORED_ZEROS_REASON = (
    "matrix stores explicit zero entries, which the compressed formats (DIA/gather-ELL) would drop — "
    "dumps and round trips would be lossy; staying in ELL. Strip the zeros to enable the fast formats"
)


def dia_fits(ndiag: int, n: int, nnz: int, itemsize: int, *, max_diags: int, max_inflation: float,
             max_storage_bytes: int) -> bool:
    """The DIA budgets: the diagonal count, the stored slots per true nonzero
    (DIA streams every slot of every kept diagonal), and the storage. Shared
    by auto_structure and io.read_hpc_row_structured's no-reorder branch."""
    return (ndiag <= max_diags and ndiag * n <= max_inflation * max(nnz, 1)
            and ndiag * n * itemsize <= max_storage_bytes)


@trace.spanned("reorder.auto_structure")
def auto_structure(
    A: EllMatrix,
    *,
    max_diags: int = 4096,
    max_inflation: float = 64.0,
    max_storage_bytes: int = 8 << 30,
) -> Tuple[object, Optional[np.ndarray], StructureReport]:
    """Pick the representation an explicit matrix solves in on Hopper.

    Returns (operator, perm, report). perm is None when the matrix keeps
    its ordering; otherwise the operator is P A P^T and the caller solves in
    the permuted basis (permute b once, unpermute x once: see
    ``io.read_hpc_row_structured``). The operator lies on A's device.

    The rule, in order:

    - a matrix that stores explicit zeros stays ELL as loaded (DIA would
      drop them);
    - direct DIA: at most ``max_diags`` diagonals, slot inflation
      ndiag*n/nnz <= 4 and storage within ``max_storage_bytes``: DIA as
      loaded, no RCM (the JAX package's banded fast path);
    - otherwise RCM, and DIA in the RCM basis (``dia+rcm``) if it meets the
      diagonal, inflation (``max_inflation``) and storage budgets *and*
      streams fewer bytes per SpMV than ELL: DIA streams ndiag*n*s, ELL
      width*n*(s + 4), s the value size in bytes;
    - else ELL, in the RCM basis (``ell+rcm``) if RCM reduced the
      bandwidth, as loaded (``ell``) otherwise.

    The byte rule is provisional: it counts the matrix's bytes and ignores
    how the gathered x reads fall in L2, which H100 timings of both kernels
    on the same matrices will settle (PERF.md).
    """
    n = A.local_nrow
    nnz = A.nnz
    s = A.vals.element_size()
    budgets = dict(max_diags=max_diags, max_inflation=max_inflation, max_storage_bytes=max_storage_bytes)
    band0 = _band(A)
    if band0.stored_zeros:
        return A, None, StructureReport("ell", None, band0.bandwidth, band0.bandwidth, None, STORED_ZEROS_REASON)
    inflation0 = band0.ndiag * n / max(nnz, 1)
    if inflation0 <= 4.0 and dia_fits(band0.ndiag, n, nnz, s, **budgets):
        with trace.span("reorder.to_dia"):
            dia = A.to_dia(max_diags=max_diags)
        return dia, None, StructureReport(
            "dia", band0.ndiag, band0.bandwidth, band0.bandwidth, inflation0,
            f"banded as loaded: {band0.ndiag} diagonals")
    perm = rcm_permutation(A)
    B = permute_ell(A, perm)
    band1 = _band(B)
    inflation1 = band1.ndiag * n / max(nnz, 1)
    dia_bytes, ell_bytes = band1.ndiag * n * s, A.width * n * (s + 4)
    rcm = f"RCM reduced bandwidth {band0.bandwidth} -> {band1.bandwidth}"
    if dia_fits(band1.ndiag, n, nnz, s, **budgets) and dia_bytes < ell_bytes:
        with trace.span("reorder.to_dia"):
            dia = B.to_dia(max_diags=max_diags)
        return dia.to(A.device), perm, StructureReport(
            "dia+rcm", band1.ndiag, band0.bandwidth, band1.bandwidth, inflation1,
            f"{rcm}; {band1.ndiag} diagonals at {inflation1:.1f}x slot inflation, {dia_bytes} B per SpMV "
            f"against ELL's {ell_bytes}")
    why = (f"DIA in the RCM basis would take {band1.ndiag} diagonals at {inflation1:.1f}x slot inflation, "
           f"{dia_bytes} B per SpMV against ELL's {ell_bytes}")
    if band1.bandwidth < band0.bandwidth:
        return B.to(A.device), perm, StructureReport(
            "ell+rcm", None, band0.bandwidth, band1.bandwidth, None, f"{rcm}; ELL gather ({why})")
    return A, None, StructureReport(
        "ell", None, band0.bandwidth, band1.bandwidth, None,
        f"no band: RCM left bandwidth {band0.bandwidth} -> {band1.bandwidth}; ELL gather as loaded ({why})")


# The relabel rule (PERF.md, PR 12: the band and grid sweeps on the card).
# A square float32/float64 matrix as loaded is gathered in RCM order when
# the median group of GROUP consecutive rows gathers from at least
# RELABEL_SPAN bytes of x (permuted stencils: the relabelled form lost to
# K11 at 55 kB and won from 110 kB up) and RCM shrinks that span at least
# RELABEL_GAIN times (a random band gains nothing from RCM: relabelled it
# ran 23-30% slower than K11's loop).
RELABEL_SPAN = 96 << 10
RELABEL_GAIN = 4.0
GROUP = 32


def group_span(cols: torch.Tensor, valid: torch.Tensor, itemsize: int) -> float:
    """The median, over the groups of GROUP consecutive rows, of the bytes of
    x between the lowest and the highest column the group gathers (on the
    tensors' device)."""
    n, width = cols.shape
    if n == 0 or width == 0 or not bool(valid.any()):
        return 0.0
    pad = -n % GROUP
    if pad:
        cols = torch.cat([cols, cols.new_zeros((pad, width))])
        valid = torch.cat([valid, valid.new_zeros((pad, width))])
    cols, valid = cols.view(-1, GROUP * width), valid.view(-1, GROUP * width)
    lo = torch.where(valid, cols, torch.iinfo(cols.dtype).max).amin(dim=1)
    hi = torch.where(valid, cols, -1).amax(dim=1)
    live = hi >= 0
    return float(((hi - lo + 1)[live].double() * itemsize).median())


def bfs_depth(A: EllMatrix, limit: Optional[int] = None) -> int:
    """The levels of a breadth-first search of A's graph from a
    pseudo-peripheral row (the last row reached from row 0), as RCM's own
    search starts; on A's device, each level expanding its frontier's
    columns. With ``limit``, the search stops where the answer's side of
    ``limit`` is known: at ``limit`` levels, or after the search from row 0
    when twice its depth (a bound on any search's) stays below ``limit``."""
    n = A.local_nrow
    seen = torch.zeros(n, dtype=torch.bool, device=A.cols.device)
    mark = torch.zeros_like(seen)

    def search(start: int):
        seen.zero_()
        seen[start] = True
        frontier, depth = torch.tensor([start], device=seen.device), 0
        while limit is None or depth < limit:
            mark.zero_()
            mark[A.cols[frontier][A.valid[frontier]].long()] = True
            mark.logical_and_(~seen)
            reached = mark.nonzero().squeeze(1)
            if reached.numel() == 0:
                break
            seen.logical_or_(mark)
            frontier, depth = reached, depth + 1
        return depth, int(frontier[-1])

    depth, last = search(0)
    if limit is not None and (depth >= limit or 2 * depth < limit):
        return depth
    return max(depth, search(last)[0])


_RCM = {}  # id(A.cols) -> (weak reference to A.cols, (cols, valid versions), RCM permutation)


def _rcm_cached(A: EllMatrix) -> np.ndarray:
    """A's reverse Cuthill-McKee order, computed once per matrix on the
    host (kept while A.cols lives and neither A.cols nor A.valid changes)."""
    key = (A.cols._version, A.valid._version)
    hit = _RCM.get(id(A.cols))
    if hit is not None and hit[0]() is A.cols and hit[1] == key:
        return hit[2]
    perm = rcm_permutation(A.to("cpu"))
    _RCM[id(A.cols)] = (weakref.ref(A.cols), key, perm)
    weakref.finalize(A.cols, _RCM.pop, id(A.cols), None)
    return perm


def relabel_order(A: EllMatrix) -> Optional[np.ndarray]:
    """The RCM order in which the ELL kernel should gather A as loaded (K13's
    relabelled kernel), or None where K11/K12 gather A in its own order.

    Only a square float32 or float64 matrix qualifies (bf16 stays on K11, as
    the JAX package's chooser never builds a gather tier for 2-byte values,
    ``hpccg_tpu/reorder.py:257-259``), and only where its median group of
    rows spans at least RELABEL_SPAN bytes of x. A pre-test on the device
    then bounds what RCM can reach before the host computes it: RCM's groups
    gather from about three levels of a breadth-first search, ``3 n /
    depth`` rows (3.0-3.4 times that on permuted stencils, more on random
    bands), so a matrix whose search is shallow (a random band: a few
    levels) cannot gain RELABEL_GAIN and is never sent to the host. Where the
    pre-test passes, the RCM order (computed once per matrix) is kept if it
    shrinks the median span RELABEL_GAIN times."""
    n = A.local_nrow
    if A.dtype not in (torch.float32, torch.float64) or A.start_row != 0 or (A.total_nrow or n) != n:
        return None
    size = A.vals.element_size()
    span = group_span(A.cols, A.valid, size)
    if span < RELABEL_SPAN:
        return None
    levels = math.ceil(3 * n * size * RELABEL_GAIN / span)
    if bfs_depth(A, levels) < levels:
        return None
    perm = _rcm_cached(A)
    index = torch.from_numpy(perm).to(A.device)
    inv = torch.empty_like(index)
    inv[index] = torch.arange(n, device=A.device)
    if group_span(inv[A.cols.long()][index], A.valid[index], size) * RELABEL_GAIN > span:
        return None
    return perm
