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
of K15 (cg, cg1) or K16 (pipecg) (``ops/cuda/collective.py``): halo planes
and the allreduce travel through memory inside the kernel.
"""

from __future__ import annotations

import dataclasses

import torch

from hpccg_tpu_torch.config import ProblemConfig
from hpccg_tpu_torch.models.stencil import Problem
from hpccg_tpu_torch.operators import StencilOperator
from hpccg_tpu_torch.parallel.halo import HaloPlanes, kernel_matvec, kernel_matvec_pap, stencil_matvec_halo
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
    """``auto`` -> on CUDA ``pallas`` for float32 and ``pallas_dd`` for
    float64 (K2 / K7 with halo planes; bfloat16, which K1-K4 do not take
    yet, runs ``stencil``), ``stencil`` on the CPU."""
    if backend not in DISTRIBUTED_BACKENDS:
        raise ValueError(f"unknown distributed backend {backend!r} (choose from {DISTRIBUTED_BACKENDS})")
    if backend != "auto":
        return backend
    if torch.device(device).type != "cuda":
        return "stencil"
    return {torch.float32: "pallas", torch.float64: "pallas_dd"}.get(cfg_local.dtype, "stencil")


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
    solve in one launch of K15/K16); ``auto`` as resolve_distributed_backend.
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

    if which in ("pallas", "pallas_dd"):
        def solve_pap(b, x0):
            bs = shards(b)
            parts = RankPartials([num_partials(op, v.device) for v in bs], bs[0].dtype, mesh.devices)

            def matvec_pap(p, Ap, active):
                return kernel_matvec_pap(op, halo, p, Ap, parts, active, dd=which == "pallas_dd")

            return cg_solve(lambda vs: kernel_matvec(op, halo, vs), bs, shards(x0), matvec_pap=matvec_pap, **kw)

        return solve_pap

    if which == "pallas_v1":
        return lambda b, x0: cg_solve(make_matvec(), shards(b), shards(x0), **kw)
    return lambda b, x0: cg_solve(make_matvec(), shards(b), shards(x0), finalize=cg_finalize_plain, **kw)

