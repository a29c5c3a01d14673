"""Matrix IO: the reference's "HPC row" text format
(read_HPC_row.cpp:217-373; ``hpccg_tpu.io``).

Token stream: ``total_nrow total_nnz``, then the nnz-per-row counts, then
(val, ind) pairs row-major, then (x, b, xexact) triples. Only the tokens
matter, not the line breaks. Reading and writing are vectorised NumPy: one
``bytes.split`` pass in, and formatted arrays joined in one pass out.

The structure analysis (``reorder.auto_structure``, ``to_dia``) runs on host
arrays: the readers hold the matrix in CPU tensors over numpy's memory and
move only the representation that solves to the device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from hpccg_tpu_torch.models.stencil import Problem
from hpccg_tpu_torch.operators import DiaMatrix, EllMatrix, StencilOperator, unique_offsets
from hpccg_tpu_torch.reorder import STORED_ZEROS_REASON, StructureReport, auto_structure, dia_fits


def _tokenize(path: str) -> np.ndarray:
    """All whitespace-separated numeric tokens, as float64."""
    with open(path, "rb") as f:
        toks = f.read().split()
    if not toks:
        return np.zeros((0,), np.float64)
    return np.array(toks, dtype=np.float64)


def _values(a: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    """Parsed float64 values as a CPU tensor of ``dtype``, cast once: numpy
    casts to float32 and float64; bfloat16, which numpy lacks, is cast by
    torch from the float64 values. torch rounds that cast through float32,
    as ``ml_dtypes`` does in the JAX package's reader, so both read the same
    bits."""
    if dtype == torch.bfloat16:
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float64)).to(dtype)
    return torch.from_numpy(np.ascontiguousarray(a).astype(torch.empty((), dtype=dtype).numpy().dtype))


def read_hpc_row(path: str, *, dtype=torch.float64, to_dia: bool = True,
                 device="cuda") -> Tuple[Problem, torch.Tensor]:
    """Load an HPC-row file into an explicit-matrix Problem on ``device``.

    Returns (problem, x_file): the file carries an initial guess x beside b
    and xexact (read_HPC_row.cpp:331-347); problem.x0 is that guess. With
    ``to_dia`` a matrix of at most 128 distinct diagonals (every stencil
    file) becomes a DiaMatrix; any other stays in padded ELL. ``dtype``:
    float32, float64 or bfloat16 (the values parsed in float64 and cast
    once, :func:`_values`)."""
    toks = _tokenize(path)
    if toks.size < 2:
        raise ValueError(f"{path}: not an HPC-row file (fewer than 2 tokens)")
    nrow, nnz = int(toks[0]), int(toks[1])
    counts = toks[2 : 2 + nrow].astype(np.int64)
    if counts.size < nrow or counts.sum() != nnz:
        raise ValueError(f"{path}: header claims nrow={nrow} nnz={nnz}, "
                         f"counts sum to {counts.sum() if counts.size == nrow else 'short file'}")
    pos = 2 + nrow
    pairs = toks[pos : pos + 2 * nnz]
    if pairs.size < 2 * nnz:
        raise ValueError(f"{path}: truncated (val, ind) section")
    pos += 2 * nnz
    tail = toks[pos : pos + 3 * nrow]
    if tail.size < 3 * nrow:
        raise ValueError(f"{path}: truncated x/b/xexact section")

    width = int(counts.max()) if nrow else 0
    vals = np.zeros((nrow, width), np.float64)
    cols = np.zeros((nrow, width), np.int32)
    valid = np.zeros((nrow, width), bool)
    row_ids = np.repeat(np.arange(nrow), counts)
    slot_ids = np.arange(nnz) - np.repeat(np.cumsum(counts) - counts, counts)
    vals[row_ids, slot_ids] = pairs[0::2]
    cols[row_ids, slot_ids] = pairs[1::2].astype(np.int64)
    valid[row_ids, slot_ids] = True
    A = EllMatrix(vals=_values(vals, dtype), cols=torch.from_numpy(cols), valid=torch.from_numpy(valid),
                  start_row=0, total_nrow=nrow)
    dia = A.to_dia() if to_dia else None
    A = A if dia is None else dia
    x, b, xexact = (_values(tail[k::3], dtype).to(device) for k in range(3))
    prob = Problem(A=A.to(device), b=b, x0=x, xexact=xexact, total_nrow=nrow, total_nnz_model=nnz,
                   total_nnz_exact=nnz)
    return prob, prob.x0


def read_hpc_row_structured(path: str, *, dtype=torch.float64, max_diags: int = 4096,
                            max_inflation: float = 64.0, reorder: bool = True, device="cuda"):
    """Load an HPC-row file and pick the representation it solves in
    (``reorder.auto_structure``).

    Returns (problem, perm, report): ``problem`` is in the *solve* basis (b,
    x0 and xexact permuted with A) on ``device``; ``perm`` is None when the
    file's order is kept, else ``x_file[perm[i]] = x_solve[i]``
    (:func:`unpermute`). ``reorder=False`` (the CLI's ``--no-reorder``)
    disables RCM but keeps the direct DIA conversion under the same budgets.
    """
    prob, _ = read_hpc_row(path, dtype=dtype, to_dia=False, device="cpu")  # analysed on the host
    A = prob.A
    max_storage = 8 << 30
    if reorder:
        op, perm, report = auto_structure(A, max_diags=max_diags, max_inflation=max_inflation,
                                          max_storage_bytes=max_storage)
    else:
        perm = None
        rows, cols, vals = A.to_coo()
        ndiag = int(unique_offsets(cols.astype(np.int64) - rows).size)
        n = A.local_nrow
        zeros = bool(np.any(vals == 0))
        fits = dia_fits(ndiag, n, A.nnz, A.vals.element_size(), max_diags=max_diags,
                        max_inflation=max_inflation, max_storage_bytes=max_storage)
        if fits and not zeros:
            op = A.to_dia(max_diags=max_diags)
            report = StructureReport("dia", ndiag, 0, None, None,
                                     f"banded as loaded: {ndiag} diagonals (reorder off)")
        else:
            op = A
            reason = ("reorder disabled; " + STORED_ZEROS_REASON if zeros
                      else f"reorder disabled; not directly banded ({ndiag} diagonals) — ELL gather")
            report = StructureReport("ell", None, 0, None, None, reason)
    vecs = {name: getattr(prob, name) for name in ("b", "x0", "xexact")}
    if perm is not None:
        index = torch.from_numpy(np.ascontiguousarray(perm, dtype=np.int64))
        vecs = {name: v[index] for name, v in vecs.items()}
    prob = dataclasses.replace(prob, A=op.to(device), **{name: v.to(device) for name, v in vecs.items()})
    return prob, perm, report


def pad_problem_rows(prob: Problem, multiple: int) -> Problem:
    """An explicit-matrix problem padded so that its row count divides
    ``multiple`` (a mesh's rank count: equal row blocks), on the matrix's
    device (``hpccg_tpu.io.pad_problem_rows``).

    Pad rows are decoupled identity rows with b = x0 = xexact = 0: they
    solve to exactly 0 and add exactly 0 to every dot product, and no real
    row references them, so the CG trajectory on the real rows is the
    unpadded problem's. A DiaMatrix without offset 0 gets a zero diagonal
    there first, for the pad rows' ones. ``total_nrow`` is the padded count;
    the FLOP and nonzero models keep the file's counts."""
    n = prob.total_nrow
    npad = -(-n // multiple) * multiple
    if npad == n:
        return prob
    A = prob.A
    if isinstance(A, EllMatrix):
        width = max(A.width, 1)
        dev = A.device
        vals = torch.zeros((npad, width), dtype=A.dtype, device=dev)
        cols = torch.zeros((npad, width), dtype=torch.int32, device=dev)
        valid = torch.zeros((npad, width), dtype=torch.bool, device=dev)
        vals[:n, : A.width], cols[:n, : A.width], valid[:n, : A.width] = A.vals, A.cols, A.valid
        vals[n:, 0] = 1.0
        cols[n:, 0] = torch.arange(n, npad, dtype=torch.int32, device=dev)
        valid[n:, 0] = True
        A2 = EllMatrix(vals=vals, cols=cols, valid=valid, start_row=0, total_nrow=npad)
    elif isinstance(A, DiaMatrix):
        offs = list(A.offsets)
        data = A.data
        if 0 not in offs:
            at = int(np.searchsorted(np.asarray(offs, dtype=np.int64), 0))
            offs.insert(at, 0)
            zero = torch.zeros((1, n), dtype=data.dtype, device=data.device)
            data = torch.cat([data[:at], zero, data[at:]])
        data2 = torch.zeros((len(offs), npad), dtype=data.dtype, device=data.device)
        data2[:, :n] = data
        data2[offs.index(0), n:] = 1.0
        A2 = DiaMatrix(data=data2, offsets=tuple(offs), total_nrow=npad)
    else:
        raise TypeError("pad_problem_rows pads explicit matrices; the stencil operator shards by construction")

    def padv(v):
        return torch.cat([v, torch.zeros((npad - n,), dtype=v.dtype, device=v.device)])

    return Problem(A=A2, b=padv(prob.b), x0=padv(prob.x0), xexact=padv(prob.xexact), total_nrow=npad,
                   total_nnz_model=prob.total_nnz_model, total_nnz_exact=prob.total_nnz_exact)


def unpermute(x, perm) -> np.ndarray:
    """A solve-basis vector (tensor or array) in the file's row order; a
    bfloat16 tensor comes out as float32 (exact; numpy has no bf16)."""
    if torch.is_tensor(x):
        x = x.detach().cpu()
        x = (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    else:
        x = np.asarray(x)
    if perm is None:
        return x
    out = np.empty_like(x)
    out[np.asarray(perm)] = x
    return out


def _floats(a) -> np.ndarray:
    """Tokens of a float array: the shortest text that reads back as the
    same float64 (float32 values are widened first, as ``%.17g`` of a
    float32 does), so the written values read back exactly."""
    return np.asarray(a, dtype=np.float64).astype(str)


def _join_rows(tokens: np.ndarray, row_ends: np.ndarray) -> str:
    """The tokens joined by spaces, with a newline after each index in
    ``row_ends``."""
    sep = np.full(tokens.shape, " ", dtype="<U1")
    sep[row_ends] = "\n"
    return "".join(np.char.add(tokens, sep).tolist())


def write_hpc_row(path: str, prob: Problem, x: Optional[np.ndarray] = None) -> None:
    """Write a Problem in the HPC-row format (the inverse of the reader): one
    line of counts, one line of (val, ind) pairs per non-empty row, one
    line of (x, b, xexact) per row. ``x`` defaults to zeros."""
    A = prob.A
    if isinstance(A, StencilOperator):
        raise TypeError("write_hpc_row needs an explicit matrix; use generate_ell")
    nrow = A.local_nrow
    _, cols, vals = A.to_coo()
    counts = A.nnz_per_row().cpu().numpy().astype(np.int64)
    x = np.zeros(nrow) if x is None else (x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x))
    b, xexact = (v.detach().cpu().numpy() for v in (prob.b, prob.xexact))
    pairs = np.char.add(np.char.add(_floats(vals), " "), cols.astype(str))
    triples = np.char.add(np.char.add(np.char.add(np.char.add(_floats(x), " "), _floats(b)), " "),
                          _floats(xexact))
    with open(path, "w") as f:
        f.write(f"{nrow} {int(counts.sum())}\n")
        f.write(" ".join(counts.astype(str).tolist()) + "\n")
        if pairs.size:
            f.write(_join_rows(pairs, np.cumsum(counts)[counts > 0] - 1))
        if nrow:
            f.write(_join_rows(triples, np.arange(nrow)))
