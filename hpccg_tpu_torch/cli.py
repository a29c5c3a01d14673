"""Command line (ref main.cpp:99-324; ``hpccg_tpu.cli``).

Usage:
    python -m hpccg_tpu_torch nx ny nz [options]   # generated stencil problem
    python -m hpccg_tpu_torch FILE [options]       # HPC-row file (file mode)

Stencil mode generates the problem on the device. File mode (main.cpp:
161-179) reads an HPC-row file, picks the representation it solves in
(``io.read_hpc_row_structured``: DIA or ELL, RCM-reordered where that
exposes a band, or not with ``--no-reorder``; the choice is printed on
stderr as ``# matrix structure: <format> — <reason>``) and solves in that
basis; ``--check`` compares x with xexact in the file's basis, and the
report's nx, ny and nz are 0. Both run the reference CG recurrence, print
the per-iteration residual lines and the YAML (or JSON) report with the JAX
package's keys: Time/FLOPS/MFLOPS summaries and the FLOP model of
main.cpp:224-227.

Stencil mode also takes ``--method cg1|pipecg`` (with ``--rr-every K``
residual replacement), ``--refine N`` (float64 refinement around float32
inner solves; single device) and ``--mesh N``: the z-stacked problem of N
blocks of nx*ny*nz on a single-controller mesh (``parallel``), N ranks on
the CPU with ``--device cpu``, one per card on CUDA (``--mesh N`` needs N
cards, as the JAX package needs N chips), with the distributed backends and
``--backend collective`` (the whole solve in one launch of K15/K16).

File mode at ``--mesh N`` (distributed file mode) pads the rows to a
multiple of N (identity rows, ``io.pad_problem_rows``), block-shards them
and picks a tier of ``parallel.cg`` by structure, as the JAX package does:
``--backend collective`` on a DIA matrix that K17 takes ->
``distributed:dia-collective`` (the whole solve in one launch of K17,
methods cg and cg1; pipecg runs cg1, ``--rr-every`` is ignored); a DIA band
that fits a shard -> ``dia-halo`` (K9/K10 per rank); an ELL band that fits
-> ``ell-halo`` (K11/K12 per rank); anything else -> ``ell-allgather``.
Each fallback says why on stderr. In bfloat16 the tier follows the JAX
package's: K17 refuses bf16 (collective falls back to dia-halo), and a
non-DIA matrix runs ``ell-allgather``, since the JAX package's gather-window
tier needs a gather matrix that its chooser never builds for 2-byte values
(the port's ``ell-halo`` takes bf16 through the API). ``--check`` strips
the pad rows and undoes RCM first; the report names the tier and the mesh
size. On CUDA
``--mesh N`` takes one card per rank, and K17 runs every rank on one card,
so across cards ``collective`` falls back to dia-halo (the API drives K17
on a one-card mesh: ``parallel.make_collective_dia_cg``).

Total is timed with CUDA events around a warm solve (the host clock on the
CPU). SPARSEMV is slope-timed on K1 (in bfloat16 on its bf16 instance), in
file mode on the matrix's kernel (K9/K10 for DIA,
K11/K12 for ELL; the plain matvec on backend ``stencil``); DDOT and WAXPBY on the plain torch ops, or, for
``pallas_fused``, WAXPBY on K4 (the fused x/r update with r.r) and DDOT
left empty because it is fused into K3/K4. For the whole-solve backends
(``megakernel``, ``streamkernel``) both are left empty: they are fused into
the one launch. Each row is a per-kernel micro-benchmark scaled by the
iteration count, not a component of Total.
"""

from __future__ import annotations

import argparse
import sys

import torch

from hpccg_tpu_torch.operators import DiaMatrix, StencilOperator
from hpccg_tpu_torch.solver import BACKENDS, METHODS, WHOLE_SOLVE_BACKENDS, warn_cg_only

# backends of explicit matrices only: on a generated problem the JAX package
# runs its stencil matvec under these names, which is not ported
FILE_BACKENDS = ("ell", "dia")
DTYPES = {"float64": torch.float64, "float32": torch.float32, "bfloat16": torch.bfloat16}


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="hpccg_tpu_torch",
        description="HPCCG 3-D stencil conjugate gradient on PyTorch/CUDA",
    )
    ap.add_argument("dims", nargs="+", help="nx ny nz, or an HPC-row data file")
    ap.add_argument("--stencil", type=int, default=27, choices=[27, 7])
    ap.add_argument("--max-iter", type=int, default=150)
    ap.add_argument("--tolerance", type=float, default=0.0)
    ap.add_argument(
        "--preset",
        choices=["ref500", "ref150"],
        help="ref500 = max_iter 500, tolerance 0 (main.cpp:187-188); ref150 = "
        "max_iter 150 (main_old.cpp:166). Overrides --max-iter/--tolerance",
    )
    ap.add_argument("--dtype", default="float64", choices=list(DTYPES))
    ap.add_argument("--mesh", default="1", metavar="N",
                    help="ranks of the 1-D z mesh (the 2-D HxZ mesh is not yet ported)")
    ap.add_argument(
        "--backend",
        default="auto",
        choices=[*BACKENDS, *FILE_BACKENDS, "collective"],
        help="auto = pallas_fused on CUDA (streamkernel for bfloat16), stencil on the CPU; at --mesh > 1 "
        "pallas (pallas_dd for float64) on CUDA; collective (--mesh > 1) = the whole solve in one "
        "launch of K15/K16, or of K17 for a banded (DIA) file; in file mode auto/ell/dia run the matrix's "
        "kernel and stencil its plain version, and at --mesh > 1 the tier follows the structure",
    )
    ap.add_argument("--method", default="cg", choices=list(METHODS),
                    help="cg: the reference recurrence (2 reductions/iter); cg1: Chronopoulos-Gear (1); "
                    "pipecg: Ghysels-Vanroose (the reduction overlaps the SpMV)")
    ap.add_argument("--rr-every", type=int, default=0, metavar="K",
                    help="residual replacement for --method cg1/pipecg every K iterations (0 = off; not "
                    "for the collective kernels' recurrences)")
    ap.add_argument("--refine", type=int, default=0, metavar="N",
                    help="N float64 refinement rounds around float32 inner solves (--dtype float64, "
                    "single device)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--json", action="store_true", help="emit JSON instead of YAML")
    ap.add_argument("--quiet", action="store_true", help="suppress residual lines")
    ap.add_argument("--skip-kernel-bench", action="store_true", help="skip per-kernel micro-benchmarks")
    ap.add_argument("--no-reorder", action="store_true",
                    help="file mode: no RCM reordering (solve in the file's row order)")
    ap.add_argument("--stream-load", action="store_true", help="not yet ported (distributed loading)")
    ap.add_argument("--dump-matlab", metavar="PREFIX", help="not yet ported")
    ap.add_argument("--check", action="store_true", help="report max|x - xexact| after the solve")
    ap.add_argument(
        "--validate",
        action="store_true",
        help="verify problem invariants before solving and fail fast on a non-finite result",
    )
    return ap


def _file_mode(args) -> bool:
    return len(args.dims) == 1 and not args.dims[0].isdigit()


def _not_ported(args) -> str | None:
    """The first requested feature that waits for a later slice, if any."""
    file_mode = _file_mode(args)
    if args.stream_load:
        return "--stream-load"
    if args.dump_matlab:
        return "--dump-matlab"
    if not file_mode and args.backend in FILE_BACKENDS:
        return f"--backend {args.backend} on a generated problem"
    if not args.mesh.isdigit():
        return f"--mesh {args.mesh} (the 2-D HxZ mesh)"
    return None


def _explicit_spmv(A, backend_used):
    """out = A u for an explicit matrix: its kernel (K9/K10 or K11/K12, the
    layout built here once), or the plain matvec on backend ``stencil``."""
    if backend_used == "stencil":
        return lambda u, out: out.copy_(A.matvec(u))
    from hpccg_tpu_torch.solver import explicit_kernel

    matvec = explicit_kernel(A)
    return lambda u, out: matvec(u, out=out)


def _explicit_backend(A, backend: str) -> str:
    """What an explicit matrix runs on: ``stencil`` (the plain versions) or
    ``native(<type>)``, its own kernel (the JAX CLI's label)."""
    return "stencil" if backend == "stencil" else f"native({type(A).__name__})"


def _kernel_bench(prob, backend_used, device):
    """Seconds per call of (ddot, waxpby, spmv), slope-timed; NaN where a
    row is fused into another kernel or has no kernel for the dtype."""
    from hpccg_tpu_torch.config import scalar_dtype
    from hpccg_tpu_torch.ops.cuda.fused_cg import update_x_r
    from hpccg_tpu_torch.ops.cuda.stencil import spmv_stencil
    from hpccg_tpu_torch.utils.timing import time_loop_slope

    op = prob.A
    if isinstance(op, StencilOperator):
        bufs = [op.grid(prob.xexact.clone()), torch.empty_like(op.grid(prob.b))]

        def apply(u, out):
            spmv_stencil(op, u, out=out)
    else:
        bufs = [prob.xexact.clone(), torch.empty_like(prob.b)]
        apply = _explicit_spmv(op, backend_used)

    def spmv_loop(k):
        for i in range(k):
            apply(bufs[i % 2], bufs[(i + 1) % 2])

    t_spmv = time_loop_slope(spmv_loop, device=device)
    if backend_used in WHOLE_SOLVE_BACKENDS:
        return float("nan"), float("nan"), t_spmv
    if backend_used == "pallas_fused":
        x, r, p, ap = (prob.b.clone() for _ in range(4))
        alpha = torch.zeros((1,), dtype=scalar_dtype(prob.b.dtype), device=device)
        part = None

        def k4_loop(k):
            nonlocal part
            for _ in range(k):
                part = update_x_r(x, r, p, ap, alpha, partials=part)[2]

        return float("nan"), time_loop_slope(k4_loop, device=device), t_spmv

    return (*_vector_bench(prob.b, prob.x0.clone(), device), t_spmv)


def _vector_bench(x_in, w, device):
    """Seconds per call of ddot(x, x) and of w = x + 0.5 w (plain torch),
    slope-timed."""
    from hpccg_tpu_torch.ops.vector import ddot, waxpby
    from hpccg_tpu_torch.utils.timing import time_loop_slope

    def wax_loop(k):
        nonlocal w
        for _ in range(k):
            w = waxpby(1.0, x_in, 0.5, w)

    def dot_loop(k):
        for _ in range(k):
            ddot(x_in, x_in)

    return time_loop_slope(dot_loop, device=device), time_loop_slope(wax_loop, device=device)


def _distributed(args, cfg, ndev: int, device):
    """(solve, sharded problem, mesh, backend label) for --mesh N > 1: N
    ranks on the CPU with --device cpu, else one per CUDA card."""
    from hpccg_tpu_torch.parallel import generate_problem_sharded, make_distributed_cg, make_mesh
    from hpccg_tpu_torch.parallel.cg import resolve_distributed_backend

    mesh = make_mesh(ndev, devices=[device] * ndev if device.type == "cpu" else None)
    prob = generate_problem_sharded(cfg, mesh)
    backend = args.backend
    if backend in WHOLE_SOLVE_BACKENDS:
        print(f"# --backend {backend} is not a distributed solver backend; using auto", file=sys.stderr)
        backend = "auto"
    backend = warn_cg_only(resolve_distributed_backend(cfg, backend, device), args.method)
    if backend == "collective" and not mesh.one_device:
        raise ValueError(f"--backend collective runs every rank on one card; --mesh {ndev} spans {ndev} cards "
                         "(the multi-card launch is queued in ROADMAP)")
    solve = make_distributed_cg(cfg, mesh, max_iter=args.max_iter, tolerance=args.tolerance, backend=backend,
                                method=args.method, replace_every=args.rr_every)
    return solve, prob, mesh, f"distributed:{backend}"


def _distributed_file(args, prob, ndev: int, device):
    """(solve, sharded problem, mesh, backend label) for FILE --mesh N > 1:
    the rows padded to N ranks and the tier chosen by structure
    (``hpccg_tpu.cli``'s order: dia-collective, dia-halo, ell-halo,
    ell-allgather), each fallback said on stderr."""
    import dataclasses
    import functools

    from hpccg_tpu_torch.io import pad_problem_rows
    from hpccg_tpu_torch.parallel import cg as pcg
    from hpccg_tpu_torch.parallel import make_mesh

    def note(msg):
        print(f"# {msg}", file=sys.stderr)

    mesh = make_mesh(ndev, devices=[device] * ndev if device.type == "cpu" else None)
    want_collective = args.backend == "collective"
    if want_collective and args.method not in ("cg", "cg1"):
        note(f"the collective DIA kernel implements the cg and cg1 recurrences; ignoring --method {args.method} "
             "(running cg1)")
        args.method = "cg1"
    elif not want_collective and args.backend != "auto":
        note(f"distributed file mode picks the kernel tier by matrix structure; ignoring --backend {args.backend}")
    prob = pad_problem_rows(prob, ndev)
    A, L = prob.A, prob.total_nrow // ndev
    tier, explained = None, False
    if want_collective and isinstance(A, DiaMatrix):
        ok, reason = pcg.collective_dia_supported(A, mesh, args.method)
        if ok:
            rec = ("reference cg recurrence, 2 in-kernel allreduces/iter" if args.method == "cg"
                   else "cg1 single-reduction recurrence")
            note(f"backend=collective: whole-solve kernel K17, in-kernel band strips + allreduce ({rec})")
            if args.rr_every:
                note("--rr-every does not apply to the in-kernel collective recurrences; ignoring")
            tier = "dia-collective"
        else:
            explained = True
            note(f"collective unavailable: {reason}; falling back (the fallback tier runs --method {args.method})")
    if tier is None and isinstance(A, DiaMatrix):
        ok, reason = pcg.dia_halo_plan(A, L)
        if ok:
            tier = "dia-halo"
        else:
            note(f"{reason}; using the all-gather ELL path")
            A, tier = A.to_ell(), "ell-allgather"
    if tier is None:
        ok, reason = pcg.ell_halo_plan(A, L)
        if ok and A.dtype == torch.bfloat16:
            ok, reason = False, ("bfloat16: the ELL halo tier stands for the JAX package's gather-window tier, whose "
                                 "gather matrix its chooser never builds for 2-byte values")
        tier = "ell-halo" if ok else "ell-allgather"
        if not ok:
            note(f"{reason}; using the all-gather ELL path")
    if want_collective and tier != "dia-collective" and not explained:
        note(f"--backend collective applies to banded (DIA) file matrices; this matrix ran distributed:{tier}")
    prob = pcg.shard_problem(dataclasses.replace(prob, A=A), mesh)
    kw = dict(max_iter=args.max_iter, tolerance=args.tolerance, method=args.method)
    if tier == "dia-collective":
        make = pcg.make_collective_dia_cg(mesh, **kw)
    else:
        make = {"dia-halo": pcg.make_distributed_dia_cg, "ell-halo": pcg.make_distributed_ell_halo_cg,
                "ell-allgather": pcg.make_distributed_ell_cg}[tier](mesh, replace_every=args.rr_every, **kw)
    return functools.partial(make, prob.A), prob, mesh, f"distributed:{tier}"


def _kernel_bench_file_distributed(prob, backend_used, device, mesh):
    """(ddot, waxpby, spmv) seconds per call in distributed file mode: the
    tier's per-rank kernel with the exchange timed apart
    (``parallel.cg.make_distributed_spmv_bench``), DDOT and WAXPBY on the
    global vectors (NaN for dia-collective, where they are fused)."""
    from hpccg_tpu_torch.parallel.cg import make_distributed_spmv_bench
    from hpccg_tpu_torch.utils.timing import time_loop_slope

    tier = backend_used.split(":", 1)[1]
    step = make_distributed_spmv_bench(mesh, prob.A, tier)

    def spmv_loop(k):
        for _ in range(k):
            step()

    t_spmv = time_loop_slope(spmv_loop, device=device)
    if tier == "dia-collective":
        return float("nan"), float("nan"), t_spmv
    return (*_vector_bench(mesh.unshard(prob.b), mesh.unshard(prob.x0), device), t_spmv)


FILE_SPMV_NOTES = {
    "dia-collective": "the dia-halo tier's K9/K10 DIA kernel on each rank's extended vector (the collective whole "
                      "solve has no standalone SpMV)",
    "dia-halo": "the K9/K10 DIA kernel on each rank's extended vector (the band-strip exchange timed apart)",
    "ell-halo": "the K11/K12 ELL gather kernel on each rank's extended vector (the band-strip exchange timed apart)",
    "ell-allgather": "the x all-gather and the K11/K12 ELL gather kernel",
}


def _file_basis(x, nrow: int, perm):
    """A solve-basis vector (flat or sharded) in the file's basis: the pad
    rows stripped, RCM undone; a CPU tensor."""
    from hpccg_tpu_torch.io import unpermute

    flat = x if isinstance(x, torch.Tensor) else torch.cat([v.cpu() for v in x])
    return torch.from_numpy(unpermute(flat[:nrow], perm))


def _kernel_bench_distributed(prob, backend_used, device, mesh, cfg):
    """(ddot, waxpby, spmv) seconds per call at --mesh > 1: the sharded
    matvec of the tier that solved (K1 with halo planes, or the plain halo'd
    matvec on stencil), DDOT and WAXPBY on the global vectors (NaN for the
    collective whole solve, where they are fused)."""
    from hpccg_tpu_torch.parallel.cg import local_operator
    from hpccg_tpu_torch.parallel.halo import HaloPlanes, kernel_matvec, stencil_matvec_halo
    from hpccg_tpu_torch.utils.timing import time_loop_slope

    op = local_operator(cfg)
    halo = HaloPlanes(op, mesh.devices, cfg.dtype)
    bufs = [tuple(v.clone() for v in prob.xexact), tuple(torch.empty_like(v) for v in prob.b)]

    def spmv_loop(k):
        for i in range(k):
            if backend_used == "distributed:stencil":
                bufs[(i + 1) % 2] = stencil_matvec_halo(op, bufs[i % 2])
            else:
                kernel_matvec(op, halo, bufs[i % 2], bufs[(i + 1) % 2])

    t_spmv = time_loop_slope(spmv_loop, device=device)
    if backend_used == "distributed:collective":
        return float("nan"), float("nan"), t_spmv
    return (*_vector_bench(mesh.unshard(prob.b), mesh.unshard(prob.x0), device), t_spmv)


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    if args.preset:
        args.max_iter = {"ref500": 500, "ref150": 150}[args.preset]
        args.tolerance = 0.0
    missing = _not_ported(args)
    if missing is not None:
        print(f"error: {missing} is not yet ported to hpccg_tpu_torch", file=sys.stderr)
        return 2
    file_mode = _file_mode(args)
    if not file_mode and (len(args.dims) != 3 or not all(d.isdigit() for d in args.dims)):
        print(f"error: expected nx ny nz or one HPC-row file, got {' '.join(args.dims)}", file=sys.stderr)
        return 2
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("error: no CUDA device available; pass --device cpu to run on the CPU")

    from hpccg_tpu_torch import ProblemConfig, generate_problem
    from hpccg_tpu_torch.solver import make_cg, solve_backend
    from hpccg_tpu_torch.utils.report import Report
    from hpccg_tpu_torch.utils.timing import elapsed, fence

    dtype = DTYPES[args.dtype]
    if file_mode:
        from hpccg_tpu_torch.io import read_hpc_row_structured

        try:
            prob, perm, structure = read_hpc_row_structured(args.dims[0], dtype=dtype,
                                                             reorder=not args.no_reorder, device=device)
        except (OSError, ValueError) as err:
            print(f"error: cannot read {args.dims[0]}: {err}", file=sys.stderr)
            return 2
        print(f"# matrix structure: {structure.format} — {structure.reason}", file=sys.stderr)
        file_nrow = prob.total_nrow  # before any --mesh row padding
        nx = ny = nz = 0
        backend_used = _explicit_backend(prob.A, args.backend)
    else:
        nx, ny, nz = (int(d) for d in args.dims)
        cfg = ProblemConfig(nx, ny, nz, stencil=args.stencil, dtype=dtype)
    ndev = int(args.mesh)
    mesh = None
    if ndev > 1 and args.refine > 0:
        print("# --refine is a single-device path; ignoring it for this solve (use --mesh 1)", file=sys.stderr)
        args.refine = 0
    if not file_mode and args.backend == "collective" and ndev <= 1:
        print("# --backend collective needs --mesh > 1 (the whole solve of every rank in one launch); "
              "using auto", file=sys.stderr)
        args.backend = "auto"
    if file_mode and ndev > 1 and args.validate:  # the invariants, before the rows are padded and sharded
        from hpccg_tpu_torch.utils.checks import validate_problem

        print(f"# problem validated: {validate_problem(prob)}", file=sys.stderr)
    try:
        if file_mode and ndev > 1:
            solve, prob, mesh, backend_used = _distributed_file(args, prob, ndev, device)
        elif ndev > 1:
            solve, prob, mesh, backend_used = _distributed(args, cfg, ndev, device)
        elif args.refine > 0:
            if dtype != torch.float64:
                print("error: --refine requires --dtype float64", file=sys.stderr)
                return 2
            from hpccg_tpu_torch.solver import cg_solve_refined

            if not file_mode:
                prob = generate_problem(cfg, device)
            backend_used = f"refine({args.backend})"

            def solve(b, x0):
                return cg_solve_refined(prob.A, b, x0, inner_max_iter=args.max_iter, outer_max_iter=args.refine,
                                        tolerance=args.tolerance, backend=args.backend, method=args.method,
                                        replace_every=args.rr_every)
        else:
            if not file_mode:
                prob = generate_problem(cfg, device)
                backend_used = solve_backend(args.backend, args.method, device, dtype)
            solve = make_cg(prob.A, max_iter=args.max_iter, tolerance=args.tolerance, backend=args.backend,
                            method=args.method, replace_every=args.rr_every)
    except ValueError as err:  # a dtype the backend's kernels do not take; too few devices
        print(f"error: {err}", file=sys.stderr)
        return 2

    if args.validate and mesh is not None and not file_mode:
        print("# --validate: pre-solve invariant checks run single-device only; post-solve finiteness check "
              "still applies", file=sys.stderr)
    elif args.validate and mesh is None:
        from hpccg_tpu_torch.utils.checks import validate_problem

        print(f"# problem validated: {validate_problem(prob)}", file=sys.stderr)

    # warm solve first (the kernel build and first launches are set-up, like
    # the reference's post-setup chrono window, main.cpp:189-197)
    solve(prob.b, prob.x0)
    fence(device)
    out = []
    t_total = elapsed(lambda: out.append(solve(prob.b, prob.x0)), device)
    res = out[0]

    niters = int(res.niters)
    normr = float(res.normr)
    trace = res.trace.double().cpu().numpy()  # exact for every dtype (bf16 has no numpy dtype)

    check_residual = None
    if args.check:
        from hpccg_tpu_torch.ops.vector import compute_residual

        if file_mode:
            x, xexact = (_file_basis(v, file_nrow, perm) for v in (res.x, prob.xexact))
        else:
            x, xexact = (res.x, prob.xexact) if mesh is None else (mesh.unshard(res.x), mesh.unshard(prob.xexact))
        check_residual = float(compute_residual(x, xexact))
        print(f"Difference between computed and exact = {check_residual:.6g}")

    if args.validate:
        from hpccg_tpu_torch.utils.checks import check_finite

        check_finite(res)

    if not args.quiet:
        # ref HPCCG.cpp:342-344,356,372-373
        print_freq = min(max(args.max_iter // 10, 1), 50)
        print(f"Initial Residual = {trace[0]:.6g}")
        if args.refine > 0:
            for k in range(1, len(trace)):
                if trace[k] == trace[k]:
                    print(f"Refinement round = {k}   Residual = {trace[k]:.6g}")
        else:
            for k in range(1, niters + 1):
                if k % print_freq == 0 or k + 1 == args.max_iter:
                    print(f"Iteration = {k}   Residual = {trace[k]:.6g}")
    print(f"Elapsed time: {t_total:.6g} s", file=sys.stderr)

    # --- FLOP model (main.cpp:217-227) ---
    fniters = float(niters)
    fnrow = float(prob.total_nrow)
    fnnz = float(prob.total_nnz_model)
    fnops_ddot = fniters * 4 * fnrow
    fnops_waxpby = fniters * 6 * fnrow
    fnops_sparsemv = fniters * 2 * fnnz
    fnops = fnops_ddot + fnops_waxpby + fnops_sparsemv

    t_ddot = t_waxpby = t_spmv = float("nan")
    if not args.skip_kernel_bench:
        if mesh is None:
            t_ddot1, t_wax1, t_spmv1 = _kernel_bench(prob, backend_used, device)
        elif file_mode:
            t_ddot1, t_wax1, t_spmv1 = _kernel_bench_file_distributed(prob, backend_used, device, mesh)
        else:
            t_ddot1, t_wax1, t_spmv1 = _kernel_bench_distributed(prob, backend_used, device, mesh, cfg)
        t_ddot = t_ddot1 * 2 * fniters
        t_waxpby = t_wax1 * (1 if backend_used.endswith("pallas_fused") else 3) * fniters
        t_spmv = t_spmv1 * fniters

    # --- report (main.cpp:230-304 schema, the JAX package's keys) ---
    doc = Report("hpccg-tpu-torch", "1.0")
    par = doc.add("Parallelism")
    par.add("Number of mesh devices", ndev)
    par.add("Mesh axes", "(single device)" if mesh is None else "z")
    par.add("Device kind", torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu")
    par.add("Platform", "gpu" if device.type == "cuda" else "cpu")
    par.add("MPI not enabled (single device)" if mesh is None
            else "MPI not enabled (single-controller mesh: halo copies and rank-order sums)", "")

    dims = doc.add("Dimensions")
    dims.add("nx", nx)
    dims.add("ny", ny)
    dims.add("nz", nz)
    if mesh is not None and not file_mode:
        dims.add("global nz", nz * ndev)
    dims.add("stencil", args.stencil)
    dims.add("dtype", args.dtype)

    doc.add("Number of iterations", niters)
    doc.add("Final residual", normr)
    if check_residual is not None:
        doc.add("Difference between computed and exact", check_residual)
    doc.add("#********** Performance Summary (times in sec) ***********", "")

    ts = doc.add("Time Summary")
    ts.add("Total   ", t_total)
    ts.add("DDOT    ", t_ddot)
    ts.add("WAXPBY  ", t_waxpby)
    ts.add("SPARSEMV", t_spmv)
    fused_note = ""
    if backend_used in ("pallas_fused", "distributed:pallas_fused"):
        fused_note = "; WAXPBY times K4 (x/r update fused with r.r) once per iteration and DDOT is fused into K3/K4"
    elif backend_used in (*WHOLE_SOLVE_BACKENDS, "distributed:collective", "distributed:dia-collective"):
        fused_note = "; DDOT and WAXPBY are fused into the whole-solve kernel (one launch per solve)"
    if mesh is not None and file_mode:
        spmv_note = f"{FILE_SPMV_NOTES[backend_used.split(':', 1)[1]]} on {ndev} ranks"
    elif mesh is not None:
        spmv_note = ("the plain halo'd matvec" if backend_used == "distributed:stencil"
                     else "the K1 stencil kernel with halo planes") + f" on {ndev} ranks"
    elif not file_mode:
        spmv_note = "the K1 stencil kernel"
    elif backend_used == "stencil":
        spmv_note = f"the plain {type(prob.A).__name__} matvec"
    else:
        spmv_note = "the K9/K10 DIA kernel" if isinstance(prob.A, DiaMatrix) else "the K11/K12 ELL gather kernel"
        if dtype == torch.bfloat16:
            spmv_note += " (bf16 instance)"
    ts.add(
        f"(DDOT/WAXPBY/SPARSEMV are slope-timed micro-benchmarks; SPARSEMV is "
        f"{spmv_note}; Total timed backend={backend_used}{fused_note})",
        "",
    )

    fl = doc.add("FLOPS Summary")
    fl.add("Total   ", fnops)
    fl.add("DDOT    ", fnops_ddot)
    fl.add("WAXPBY  ", fnops_waxpby)
    fl.add("SPARSEMV", fnops_sparsemv)

    def mflops(ops: float, t: float) -> float:
        # t == 0 means "below timer resolution"; C++ prints inf (out.txt:33-37)
        if t != t:  # skipped bench -> NaN
            return float("nan")
        return ops / t / 1e6 if t > 0 else float("inf")

    mf = doc.add("MFLOPS Summary")
    mf.add("Total   ", mflops(fnops, t_total))
    mf.add("DDOT    ", mflops(fnops_ddot, t_ddot))
    mf.add("WAXPBY  ", mflops(fnops_waxpby, t_waxpby))
    mf.add("SPARSEMV", mflops(fnops_sparsemv, t_spmv))

    print(doc.to_json() if args.json else doc.generate_yaml(), end="")
    return 0


if __name__ == "__main__":
    sys.exit(main())
