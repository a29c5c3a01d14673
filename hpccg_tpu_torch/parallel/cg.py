"""Distributed CG over a single-controller mesh (ref HPCCG.cpp under
-DUSING_MPI; ``hpccg_tpu.parallel.cg``).

Vectors are sharded z-plane blocks (a tuple of flat per-rank tensors,
``parallel.mesh``); each matvec exchanges halo planes (``parallel.halo``)
and each dot product is one partial per rank, summed on rank 0's device in
rank order, where the scalars live. Per iteration that is the reference's
cost shape: two reductions (one for cg1 and pipecg), one halo exchange, one
SpMV, three vector updates. The JAX package runs the same recurrences under
shard_map; here one process drives every rank.

``backend="collective"`` runs the whole solve of every rank in one launch
of K15 (cg, cg1) or K16 (pipecg) (``ops/cuda/collective.py``), or across
cards in one launch per card: halo planes and the allreduce travel through
memory inside the kernel, between cards over peer memory.

Distributed file mode (ref main.cpp:161-179: read_HPC_row ->
make_local_matrix -> MPI CG) solves a loaded explicit matrix with its rows
block-sharded: rank r owns rows [r*L, (r+1)*L) (``shard_problem``; pad the
row count first, ``io.pad_problem_rows``). Its tiers, in the order the CLI
tries them:

- ``dia-collective`` (``make_collective_dia_cg``): K17, the whole solve of
  a banded DIA matrix in one launch, methods cg and cg1;
- ``dia-halo`` (``make_distributed_dia_cg``): K9/K10 per rank on the rank's
  extended vector (band strips, ``parallel.halo.BandStrips``);
- ``ell-halo`` (``make_distributed_ell_halo_cg``): K11/K12 per rank with
  columns remapped into the extended vector, for an ELL band that fits a
  shard;
- ``ell-allgather`` (``make_distributed_ell_cg``): K11/K12 per rank on the
  gathered global x, for every other matrix.

On the CPU every tier runs its kernels' plain versions. bfloat16 rides
every tier but ``dia-collective`` (K17 is float32/float64, as the JAX
package's is float32 only): bf16 strips and vectors, K9/K11's bf16
instances, and for ``cg`` float32 scalars, dots and trace
(``config.scalar_dtype``), as the kernel backends on one device.
"""

from __future__ import annotations

import dataclasses

import torch

from hpccg_tpu_torch.config import ProblemConfig, scalar_dtype
from hpccg_tpu_torch.models.stencil import Problem
from hpccg_tpu_torch.operators import DiaMatrix, DiaRows, EllMatrix, StencilOperator, band
from hpccg_tpu_torch.ops.cuda.dia import MAX_DIAGS, prepare_dia, spmv_dia
from hpccg_tpu_torch.ops.cuda.ell import prepare_ell, spmv_ell
from hpccg_tpu_torch.parallel.halo import (
    BandStrips,
    HaloPlanes,
    kernel_matvec,
    kernel_matvec_pap,
    stencil_matvec_halo,
)
from hpccg_tpu_torch.parallel.mesh import Z_AXIS, Axis, Mesh, axis_size
from hpccg_tpu_torch.solver import (
    ONE_REDUCTION,
    RankPartials,
    _check_dtype,
    cg_solve,
    cg_solve_fused,
    check_method,
    warn_cg_only,
)
from hpccg_tpu_torch.ops.cuda.fused_cg import cg_finalize_plain
from hpccg_tpu_torch.ops.cuda.stencil import num_partials

DISTRIBUTED_BACKENDS = ("auto", "stencil", "pallas", "pallas_dd", "pallas_v1", "pallas_fused", "collective")


def local_operator(cfg_local: ProblemConfig) -> StencilOperator:
    return StencilOperator(nx=cfg_local.nx, ny=cfg_local.ny, nz=cfg_local.nz, stencil=cfg_local.stencil,
                           dtype=cfg_local.dtype)


def generate_problem_sharded(cfg_local: ProblemConfig, mesh: Mesh, *, axis: Axis = Z_AXIS) -> Problem:
    """The global z-stacked problem of ``mesh.size`` blocks of
    ``cfg_local``, sharded over the mesh: b = A 1 built on each rank with
    the halo'd matvec (ones from the neighbours, zeros at the global ends;
    generate_matrix.cpp:284-286). ``A`` is the global operator; b, x0 and
    xexact are tuples of per-rank shards."""
    size = axis_size(mesh, axis)
    op_local = local_operator(cfg_local)
    n = cfg_local.local_nrow
    ones = tuple(torch.ones((n,), dtype=cfg_local.dtype, device=d) for d in mesh.devices)
    b = stencil_matvec_halo(op_local, ones)
    x0 = tuple(torch.zeros((n,), dtype=cfg_local.dtype, device=d) for d in mesh.devices)
    op_global = dataclasses.replace(op_local, nz=cfg_local.nz * size)
    return Problem(A=op_global, b=b, x0=x0, xexact=ones, total_nrow=n * size,
                   total_nnz_model=cfg_local.stencil.value * n * size, total_nnz_exact=op_global.nnz)


def resolve_distributed_backend(cfg_local: ProblemConfig, backend: str = "auto", device="cuda") -> str:
    """``auto`` -> on CUDA ``pallas`` for float32 and bfloat16 (K2 with
    halo planes; JAX picks it for 2-byte state, ``hpccg_tpu/parallel/
    cg.py:156-158``) and ``pallas_dd`` for float64 (K7), ``stencil`` on the
    CPU."""
    if backend not in DISTRIBUTED_BACKENDS:
        raise ValueError(f"unknown distributed backend {backend!r} (choose from {DISTRIBUTED_BACKENDS})")
    if backend != "auto":
        return backend
    if torch.device(device).type != "cuda":
        return "stencil"
    return "pallas_dd" if cfg_local.dtype == torch.float64 else "pallas"


def _method_runner(method: str, replace_every: int = 0):
    """run(matvec, b, x0, *, max_iter, tolerance, **kw) on sharded vectors
    for the one-reduction methods: their (gamma, delta) all-reduce sums the
    ranks' pairs in rank order (``solver._rank_dot2``)."""
    check_method(method)
    solver_fn = ONE_REDUCTION[method]

    def run(matvec, b, x0, **kw):
        return solver_fn(matvec, b, x0, replace_every=replace_every, **kw)

    return run


def make_distributed_cg(
    cfg_local: ProblemConfig,
    mesh: Mesh,
    *,
    max_iter: int,
    tolerance: float = 0.0,
    axis: Axis = Z_AXIS,
    backend: str = "auto",
    method: str = "cg",
    replace_every: int = 0,
):
    """solve(b, x0) -> CGResult for the z-stacked stencil on ``mesh``.

    ``b``/``x0``: sharded vectors (tuples of per-rank flat tensors, as
    ``generate_problem_sharded`` and ``Mesh.shard`` give), or global flat
    tensors, which are sharded first. The result's x is sharded; niters,
    normr, rtrans and the trace lie on rank 0's device.

    Backends: ``stencil`` (plain torch), ``pallas`` (K2 with halo planes),
    ``pallas_dd`` (K7, float64), ``pallas_v1`` (K1 and torch dots),
    ``pallas_fused`` (K3 with four planes, K4), ``collective`` (the whole
    solve in one launch of K15/K16 per card, the mesh set up on the first
    solve); ``auto`` as resolve_distributed_backend.
    bf16 shards (and halo planes) run on every backend but ``pallas_dd``,
    with float32 scalars on the kernel backends, as on one device
    (``collective``: K15/K16's bf16 instance, its plain version on the
    CPU).
    Methods ``cg``, ``cg1``, ``pipecg``: the one-reduction methods run their
    matvec on ``stencil``, K1 (``pallas``, ``pallas_v1``; ``pallas_fused``
    warns and runs ``pallas``, as on one device) or K7 (``pallas_dd``), and
    the collective kernels' own recurrences on ``collective``.
    ``replace_every`` applies to every backend but ``collective``, as in the
    JAX package.
    """
    check_method(method)
    axis_size(mesh, axis)  # rejects an axis the mesh does not have
    op = local_operator(cfg_local)
    dev = mesh.devices[0]
    which = resolve_distributed_backend(cfg_local, backend, dev)
    if which != "collective":
        which = warn_cg_only(which, method)
        _check_dtype(which, cfg_local.dtype)
    kw = dict(max_iter=max_iter, tolerance=tolerance)

    def shards(v):
        return mesh.shard(v) if isinstance(v, torch.Tensor) else tuple(v)

    if which == "collective":
        from hpccg_tpu_torch.ops.cuda.collective import cg_collective, cg_collective_pipelined

        def solve_collective(b, x0):
            bs, x0s = shards(b), shards(x0)
            if method == "pipecg":
                return cg_collective_pipelined(op, bs, x0s, **kw)
            return cg_collective(op, bs, x0s, method=method, **kw)

        return solve_collective

    halo = HaloPlanes(op, mesh.devices, cfg_local.dtype) if which != "stencil" else None

    def make_matvec():
        """The sharded A v of the backend, its buffers allocated once per
        solve."""
        if which == "stencil":
            return lambda vs: stencil_matvec_halo(op, vs)
        if which != "pallas_dd":
            return lambda vs: kernel_matvec(op, halo, vs)
        # K7's product; its partials are unused
        parts = RankPartials([num_partials(op, d) for d in mesh.devices], cfg_local.dtype, mesh.devices)
        on = torch.ones((1,), dtype=torch.int32, device=dev)

        def matvec_dd(vs):
            outs = tuple(torch.empty_like(v) for v in vs)
            kernel_matvec_pap(op, halo, vs, outs, parts, on, dd=True)
            return outs

        return matvec_dd

    if method != "cg":
        run = _method_runner(method, replace_every)
        return lambda b, x0: run(make_matvec(), shards(b), shards(x0), **kw)

    if which == "pallas_fused":
        return lambda b, x0: cg_solve_fused(op, shards(b), shards(x0), halo2=halo.planes2,
                                            halo4=halo.planes4, **kw)

    sdt = scalar_dtype(cfg_local.dtype)
    if which in ("pallas", "pallas_dd"):
        def solve_pap(b, x0):
            bs = shards(b)
            parts = RankPartials([num_partials(op, v.device) for v in bs], sdt, mesh.devices)

            def matvec_pap(p, Ap, active):
                return kernel_matvec_pap(op, halo, p, Ap, parts, active, dd=which == "pallas_dd")

            return cg_solve(lambda vs: kernel_matvec(op, halo, vs), bs, shards(x0), matvec_pap=matvec_pap,
                            scalars=sdt, **kw)

        return solve_pap

    if which == "pallas_v1":
        return lambda b, x0: cg_solve(make_matvec(), shards(b), shards(x0), scalars=sdt, **kw)
    return lambda b, x0: cg_solve(make_matvec(), shards(b), shards(x0), finalize=cg_finalize_plain, **kw)



# ------------------------------------------------------ distributed file mode


def _row_block(n: int, ndev: int) -> int:
    if n % ndev:
        raise ValueError(f"{n} rows do not divide a {ndev}-rank mesh; pad with "
                         f"hpccg_tpu_torch.io.pad_problem_rows(prob, {ndev})")
    return n // ndev


def shard_matrix(A, mesh: Mesh) -> tuple:
    """An assembled EllMatrix or DiaMatrix -> its per-rank row blocks, each
    a contiguous copy on its rank's device: EllMatrix row blocks with
    global columns (start_row = r*L, total_nrow = n), or DiaRows (the
    (ndiag, L) column blocks of the data). A tuple of blocks is returned as
    it is."""
    if isinstance(A, tuple):
        if len(A) != mesh.size:
            raise ValueError(f"{len(A)} row blocks for a {mesh.size}-rank mesh")
        return A
    n = A.local_nrow
    L = _row_block(n, mesh.size)
    rows = [slice(r * L, (r + 1) * L) for r in range(mesh.size)]
    if isinstance(A, DiaMatrix):
        return tuple(DiaRows(data=A.data[:, sl].to(d).contiguous(), offsets=tuple(A.offsets), start_row=sl.start,
                             total_nrow=n) for sl, d in zip(rows, mesh.devices))
    if isinstance(A, EllMatrix):
        if A.start_row != 0 or (A.total_nrow or n) != n:
            raise ValueError("shard_matrix needs the assembled square matrix (start_row 0), not a row shard")
        return tuple(EllMatrix(vals=A.vals[sl].to(d).contiguous(), cols=A.cols[sl].to(d).contiguous(),
                               valid=A.valid[sl].to(d).contiguous(), start_row=sl.start, total_nrow=n)
                     for sl, d in zip(rows, mesh.devices))
    raise TypeError(f"shard_matrix takes an EllMatrix or DiaMatrix, got {type(A).__name__}")


def shard_problem(prob: Problem, mesh: Mesh) -> Problem:
    """An explicit-matrix problem on ``mesh`` (``hpccg_tpu.parallel.cg.
    shard_problem``): the matrix as per-rank row blocks (``shard_matrix``)
    and b, x0, xexact as sharded vectors (``Mesh.shard``)."""
    return dataclasses.replace(prob, A=shard_matrix(prob.A, mesh), b=mesh.shard(prob.b), x0=mesh.shard(prob.x0),
                               xexact=mesh.shard(prob.xexact))


def _first(A):
    """The matrix, or its first row block."""
    return A[0] if isinstance(A, tuple) else A


def _global_rows(A) -> int:
    return sum(blk.local_nrow for blk in A) if isinstance(A, tuple) else A.local_nrow


def dia_halo_plan(A, L: int):
    """(ok, reason): can the DiaMatrix A (or its DiaRows) ride the dia-halo
    tier on L-row shards? The band must fit one shard (neighbours only) and
    K9 must take its diagonals (``hpccg_tpu.parallel.cg.dia_halo_plan``; its
    unroll/pallas/dd tiers and their diagonal caps are TPU compile limits
    with no counterpart here). The CLI's fallback and the solver's error
    both ask this, so they agree."""
    offs = _first(A).offsets
    bw_lo, bw_hi = band(offs)
    if bw_lo > L or bw_hi > L:
        return False, f"bandwidth ({bw_lo}/{bw_hi}) exceeds the {L}-row shard: neighbour halo insufficient"
    if len(offs) > MAX_DIAGS:
        return False, f"{len(offs)} diagonals exceed the DIA kernel's {MAX_DIAGS}"
    return True, ""


def ell_band(A) -> tuple:
    """(bw_lo, bw_hi) of an EllMatrix or its row blocks: how far the valid
    entries reach below and above the diagonal (global rows)."""
    lo = hi = 0
    for blk in A if isinstance(A, tuple) else (A,):
        rows = torch.arange(blk.local_nrow, device=blk.device)[:, None] + blk.start_row
        offs = (blk.cols.long() - rows)[blk.valid]
        if offs.numel():
            lo, hi = max(lo, int(-offs.min())), max(hi, int(offs.max()))
    return lo, hi


def ell_halo_plan(A, L: int):
    """(ok, reason): can the EllMatrix A (or its row blocks) ride the
    ell-halo tier on L-row shards? Its band must fit one shard."""
    bw_lo, bw_hi = ell_band(A)
    if bw_lo > L or bw_hi > L:
        return False, f"bandwidth ({bw_lo}/{bw_hi}) exceeds the {L}-row shard: neighbour halo insufficient"
    return True, ""


def _explicit_runner(method: str, replace_every: int, **kw):
    """run(matvec, bs, x0s) -> CGResult of ``method`` on sharded vectors:
    the reference recurrence with the finalize kernel (its plain version on
    the CPU; float32 scalars for bf16 vectors), or a one-reduction
    method."""
    check_method(method)
    if method == "cg":
        return lambda mv, bs, x0s: cg_solve(mv, bs, x0s, scalars=scalar_dtype(bs[0].dtype), **kw)
    run = _method_runner(method, replace_every)
    return lambda mv, bs, x0s: run(mv, bs, x0s, **kw)


def _sharded(mesh: Mesh, v) -> tuple:
    return mesh.shard(v) if isinstance(v, torch.Tensor) else tuple(v)


class HaloTier:
    """The sharded A v of a halo tier: ``dia-halo`` runs K9/K10 on each
    rank's DiaRows, ``ell-halo`` K11/K12 on each rank's ELL rows with their
    columns remapped into the extended vector (``ell_window``); both read
    the rank's extended vector from ``strips`` (plain versions on the
    CPU). Calling it fills the strips, then applies the kernels."""

    def __init__(self, blocks, devices, tier: str):
        if tier == "ell-halo":
            bw_lo, bw_hi = ell_band(blocks)
            self.kernels = [(prepare_ell(ell_window(blk, bw_lo, bw_hi)), spmv_ell) for blk in blocks]
        else:
            bw_lo, bw_hi = blocks[0].bw_lo, blocks[0].bw_hi
            self.kernels = [(prepare_dia(blk), spmv_dia) for blk in blocks]
        self.strips = BandStrips(blocks[0].local_nrow, bw_lo, bw_hi, devices, blocks[0].dtype)

    def apply(self, exts, outs=None) -> tuple:
        """Each rank's kernel on its extended vector, into ``outs``."""
        outs = outs or (None,) * len(exts)
        return tuple(kernel(S, x, out=o) for (S, kernel), x, o in zip(self.kernels, exts, outs))

    def __call__(self, vs) -> tuple:
        return self.apply(self.strips.fill(vs))


def make_distributed_dia_cg(mesh: Mesh, *, max_iter: int, tolerance: float = 0.0, method: str = "cg",
                            replace_every: int = 0):
    """The dia-halo tier: solve(A, b, x0) -> CGResult for a banded DiaMatrix
    with its rows block-sharded (``hpccg_tpu.parallel.cg.
    make_distributed_dia_cg``). Each matvec fills the band strips (rank r
    reads the last bw_lo rows of r-1 and the first bw_hi of r+1; zero at
    the global ends) and runs K9/K10 on each rank's extended vector. The
    JAX package runs a zero-halo kernel and adds the strips as boundary
    corrections, so that XLA can overlap the ppermute; here the computation
    is ported, not that workaround, and the product equals the
    single-device one bit for bit.

    ``A``: the assembled DiaMatrix (rows must divide the mesh: pad with
    ``io.pad_problem_rows``) or its DiaRows; ``b``/``x0``: global or
    sharded. Methods cg, cg1, pipecg and ``replace_every`` as
    ``make_distributed_cg``. Raises ValueError when ``dia_halo_plan``
    refuses the band."""
    run = _explicit_runner(method, replace_every, max_iter=max_iter, tolerance=tolerance)

    def solve(A, b, x0):
        blocks = shard_matrix(A, mesh)
        if not isinstance(blocks[0], DiaRows):
            raise TypeError("make_distributed_dia_cg needs a DiaMatrix")
        ok, reason = dia_halo_plan(blocks, blocks[0].local_nrow)
        if not ok:
            raise ValueError(f"{reason} — use make_distributed_ell_cg")
        return run(HaloTier(blocks, mesh.devices, "dia-halo"), _sharded(mesh, b), _sharded(mesh, x0))

    return solve


def _ell_blocks(A, mesh: Mesh) -> tuple:
    blocks = shard_matrix(A, mesh)
    if not isinstance(blocks[0], EllMatrix):
        raise TypeError("the ELL tiers need an EllMatrix")
    return blocks


def ell_allgather_matvec(blocks, mesh: Mesh):
    """The sharded A v of the ell-allgather tier: the global x gathered
    onto each rank's device (once when every rank shares one), then
    K11/K12 (plain on the CPU) on the rank's rows with global columns."""
    slots = [prepare_ell(blk) for blk in blocks]  # ncols = n: the global x

    def matvec(vs):
        if mesh.one_device:
            xs = [torch.cat(vs)] * len(vs)
        else:
            xs = [torch.cat([v.to(d) for v in vs]) for d in mesh.devices]
        return tuple(spmv_ell(S, x) for S, x in zip(slots, xs))

    return matvec


def make_distributed_ell_cg(mesh: Mesh, *, max_iter: int, tolerance: float = 0.0, method: str = "cg",
                            replace_every: int = 0):
    """The ell-allgather tier: solve(A, b, x0) -> CGResult for any
    EllMatrix with its rows block-sharded. Each matvec gathers the global x
    onto each rank's device and runs K11/K12 on the rank's rows with global
    columns (``EllSlots.ncols = n``). It stands for the JAX package's
    ``make_distributed_ell_cg`` and for its wide-scatter tiers
    ``make_distributed_stack_cg`` and ``make_distributed_dynwin_cg``, which
    all-gather x too (``hpccg_tpu/parallel/cg.py:875``, ``:972``): their
    strip and window layouts exist because the TPU has no gather. Arguments
    as ``make_distributed_dia_cg``."""
    run = _explicit_runner(method, replace_every, max_iter=max_iter, tolerance=tolerance)

    def solve(A, b, x0):
        blocks = _ell_blocks(A, mesh)
        return run(ell_allgather_matvec(blocks, mesh), _sharded(mesh, b), _sharded(mesh, x0))

    return solve


def ell_window(blk: EllMatrix, bw_lo: int, bw_hi: int) -> EllMatrix:
    """A row block with its columns remapped into its rank's extended
    vector: column c becomes c - (start_row - bw_lo), so x_ext[0] is global
    row start_row - bw_lo; ``start_row`` is then bw_lo and ``total_nrow``
    the extended length. Invalid slots keep column 0."""
    cols = torch.where(blk.valid, blk.cols - (blk.start_row - bw_lo), 0).to(torch.int32)
    return dataclasses.replace(blk, cols=cols, start_row=bw_lo, total_nrow=bw_lo + blk.local_nrow + bw_hi)


def make_distributed_ell_halo_cg(mesh: Mesh, *, max_iter: int, tolerance: float = 0.0, method: str = "cg",
                                 replace_every: int = 0):
    """The ell-halo tier: solve(A, b, x0) -> CGResult for an EllMatrix whose
    band fits one shard, with its rows block-sharded. Each matvec fills the
    band strips and runs K11/K12 on each rank's rows with their columns
    remapped into the extended vector (``ell_window``). It stands for the
    JAX package's ``make_distributed_gell_cg`` (the windowed gather tier,
    ``hpccg_tpu/parallel/cg.py:763``), whose chunk-scanning window exists
    because the TPU has no gather. Raises ValueError when ``ell_halo_plan``
    refuses the band; other arguments as ``make_distributed_dia_cg``."""
    run = _explicit_runner(method, replace_every, max_iter=max_iter, tolerance=tolerance)

    def solve(A, b, x0):
        blocks = _ell_blocks(A, mesh)
        ok, reason = ell_halo_plan(blocks, blocks[0].local_nrow)
        if not ok:
            raise ValueError(f"{reason} — use make_distributed_ell_cg")
        return run(HaloTier(blocks, mesh.devices, "ell-halo"), _sharded(mesh, b), _sharded(mesh, x0))

    return solve


ACROSS_CARDS = ("the collective DIA kernel (K17) runs every rank of a launch on one card; its multi-card launch is "
                "queued in ROADMAP")


def collective_dia_supported(A, mesh: Mesh, method: str = "cg1"):
    """(ok, reason) for K17 on ``mesh``: the one predicate that the CLI's
    fallback and ``make_collective_dia_cg`` share
    (``hpccg_tpu.parallel.cg.collective_dia_supported``). It needs float32
    or float64 data, rows that divide the ranks, a band that fits one
    shard, at most MAX_DIAGS diagonals, every rank on one card and, on
    CUDA, as many resident blocks as ranks. The reason names the fallback.
    JAX's f32-only rule (Mosaic has no f64), its rows % (ndev*128) rule
    (the TPU's lane width), its 128-diagonal cap (trace-time unroll) and its
    VMEM fit are TPU limits and are not carried over."""
    first, ndev = _first(A), mesh.size
    if first.dtype not in (torch.float32, torch.float64):
        return False, (f"the collective DIA kernel takes float32 or float64, not {first.dtype} — use "
                       "make_distributed_dia_cg")
    n = _global_rows(A)
    if n % ndev:
        return False, (f"{n} rows do not divide {ndev} ranks; pad with hpccg_tpu_torch.io.pad_problem_rows(prob, "
                       f"{ndev})")
    L = n // ndev
    bw_lo, bw_hi = band(first.offsets)
    if max(bw_lo, bw_hi) > L:
        return False, (f"bandwidth ({bw_lo}/{bw_hi}) exceeds the {L}-row shard: neighbour strips insufficient — "
                       "use make_distributed_ell_cg")
    if first.ndiag > MAX_DIAGS:
        return False, f"{first.ndiag} diagonals exceed the kernel's {MAX_DIAGS} — use make_distributed_ell_cg"
    if not mesh.one_device:
        return False, f"{ACROSS_CARDS} — use make_distributed_dia_cg"
    if mesh.devices[0].type == "cuda":
        from hpccg_tpu_torch.ops.cuda.collective import dia_resident_blocks

        with torch.cuda.device(mesh.devices[0]):
            resident = dia_resident_blocks(first.dtype, method)
        if resident < ndev:
            return False, (f"{ndev} ranks need {ndev} resident blocks; this card holds {max(resident, 0)} of the "
                           "collective DIA kernel — use make_distributed_dia_cg")
    return True, "ok"


def make_collective_dia_cg(mesh: Mesh, *, max_iter: int, tolerance: float = 0.0, method: str = "cg1"):
    """The dia-collective tier: solve(A, b, x0) -> CGResult, the whole
    multi-rank solve of a banded DiaMatrix in one launch of K17
    (``ops/cuda/collective.py:cg_collective_dia``; its plain version on the
    CPU). Methods ``cg`` (the reference recurrence, two allreduces per
    iteration) and ``cg1`` (one), as the JAX package's
    ``make_collective_dia_cg``; the band strips and the allreduce travel
    through memory inside the kernel, and ``replace_every`` does not apply.
    A mesh across cards raises NotImplementedError; anything else
    ``collective_dia_supported`` refuses raises ValueError with its
    reason. ``A``: the assembled DiaMatrix or its DiaRows."""
    if method not in ("cg", "cg1"):
        raise ValueError(f"the collective DIA kernel runs methods cg and cg1, got {method!r}")
    from hpccg_tpu_torch.ops.cuda.collective import cg_collective_dia

    def solve(A, b, x0):
        if not isinstance(_first(A), (DiaMatrix, DiaRows)):
            raise TypeError("make_collective_dia_cg needs a DiaMatrix")
        if not mesh.one_device and all(d.type == "cuda" for d in mesh.devices):
            raise NotImplementedError(ACROSS_CARDS)
        ok, reason = collective_dia_supported(A, mesh, method)
        if not ok:
            raise ValueError(reason)
        return cg_collective_dia(shard_matrix(A, mesh), _sharded(mesh, b), _sharded(mesh, x0), method=method,
                                 max_iter=max_iter, tolerance=tolerance)

    return solve


# the tiers' labels, as the CLI prints them after "distributed:"
FILE_TIERS = ("dia-collective", "dia-halo", "ell-halo", "ell-allgather")


def make_distributed_spmv_bench(mesh: Mesh, A, tier: str):
    """step() running one SpMV of ``tier`` on every rank, for slope timing
    of the CLI's SPARSEMV row in distributed file mode
    (``hpccg_tpu.parallel.cg.make_distributed_spmv_bench``). As the
    reference's TICK/TOCK brackets HPC_sparsemv and times the exchange
    apart (times[5], HPCCG.cpp:394), the halo tiers' strips are filled once,
    outside the step: it times K9/K10 or K11/K12 on each rank's extended
    vector. ell-allgather keeps its gather in the step: there the gather
    is the matvec's structure. dia-collective has no standalone SpMV: it
    times the dia-halo tier's kernel. ``A``: the row blocks (or the
    assembled matrix)."""
    if tier not in FILE_TIERS:
        raise ValueError(f"unknown distributed file tier {tier!r} (choose from {FILE_TIERS})")
    blocks = shard_matrix(A, mesh)
    xs = tuple(torch.ones((blk.local_nrow,), dtype=blk.dtype, device=d) for blk, d in zip(blocks, mesh.devices))
    if tier == "ell-allgather":
        matvec = ell_allgather_matvec(blocks, mesh)
        return lambda: matvec(xs)
    halo = HaloTier(blocks, mesh.devices, "ell-halo" if tier == "ell-halo" else "dia-halo")
    ext = halo.strips.fill(xs)
    outs = tuple(torch.empty_like(x) for x in xs)
    return lambda: halo.apply(ext, outs)
