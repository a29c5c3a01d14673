"""Headline benchmark of the port: prints ONE JSON line.

    python -m hpccg_tpu_torch.bench [--preset NAME] [--dtype ...] [--backend ...] [--device cuda|cpu]

The counterpart of the JAX package's root ``bench.py``, with its flags,
presets and keys. Protocol (ref main.cpp:187-188, BASELINE.json config 3):
27-point stencil, 100^3, fixed work (max_iter 150, tolerance 0), float32,
one device. The timed quantity is the whole CG iteration on the chosen
backend (SpMV, dots, axpys, the device scalars), not a kernel alone.

- value: SpMV nonzeros per second through whole CG iterations,
  nnz_model / t_iter with nnz_model = stencil * nrow (the reference's FLOP
  model, main.cpp:226). t_iter is the slope between a 65-iteration solve and
  a long one (1025 on the card, 257 on the CPU), taken as interleaved pairs
  with the median slope, each solve timed with CUDA events
  (``utils/timing.time_loop_slope``; the host clock on the CPU).
- vs_baseline: the reference format's speed of light on this device. An
  explicit CSR SpMV moves at least 12 B per nonzero (8 B value, 4 B column
  index), so it runs at most at bandwidth / 12 nonzeros per second, with
  the bandwidth the copy rate that the probe kernels measure on this device
  at run time (``utils/bandwidth.py``). No table of published rates.
- extras: the end-to-end max_iter solve (the fastest of --reps, CUDA
  events), K1 alone (a ping-pong of the stencil kernel at the problem's
  dtype, one CUDA graph per leg on the card, slope between 32 and 2048
  launches), both probe rates and the card's power limit.

Presets (BASELINE.json's configs): parity32 = 27-point 32^3, fused64 =
7-point 64^3, headline100 = 27-point 100^3 (the default), weak-unit = the
100^3 per-device weak-scaling block, strong256 = 256^3 on this device.
``--backend auto`` resolves as ``solver.resolve_backend``. ``BENCH_WATCHDOG_S``
(default 2400, 0 = off) dumps every thread's traceback and exits if the run
hangs. The module imports torch, never jax.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import torch

from hpccg_tpu_torch.cli import DTYPES
from hpccg_tpu_torch.solver import BACKENDS

PRESETS = {
    "parity32": (32, 27),
    "fused64": (64, 7),
    "headline100": (100, 27),
    "weak-unit": (100, 27),
    "strong256": (256, 27),
}
SHORT_ITERS = 64  # the short leg: max_iter 65
LONG_ITERS = {"cuda": 1024, "cpu": 256}  # the long leg's floor: max_iter 1025 / 257
SPMV_LEGS = (32, 2048)  # K1 launches per leg (the JAX bench's K and 64 K)
CPU_PROBE_BYTES = 8 << 20  # bytes per probe array on the CPU (the card takes 1 GiB)
OTHER_PATHS = ("whole-solve kernels (--backend megakernel, streamkernel), the per-iteration kernel backends "
               "(pallas, pallas_fused, pallas_dd) and the plain stencil backend; the one-reduction methods; "
               "explicit matrices from HPC-row files (python -m hpccg_tpu_torch FILE); the distributed mesh and "
               "the collective whole-solve kernels (--mesh N); their numbers: PERF.md")


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="hpccg_tpu_torch.bench", description=__doc__.splitlines()[0])
    ap.add_argument("--nx", type=int, default=100)
    ap.add_argument("--ny", type=int, default=100)
    ap.add_argument("--nz", type=int, default=100)
    ap.add_argument("--stencil", type=int, default=27, choices=[7, 27])
    ap.add_argument("--max-iter", type=int, default=150)
    ap.add_argument("--dtype", default="float32", choices=list(DTYPES))
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--backend", default="auto", choices=list(BACKENDS),
                    help="auto = pallas_fused on CUDA (streamkernel for bfloat16), stencil on the CPU")
    ap.add_argument("--preset", choices=list(PRESETS),
                    help="parity32 = 27-pt 32^3, fused64 = 7-pt 64^3, headline100 = 27-pt 100^3 (the default), "
                    "weak-unit = the 100^3 weak-scaling block, strong256 = 256^3 on this device; overrides "
                    "--nx/--ny/--nz/--stencil")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap


def apply_preset(args) -> None:
    """Set the grid and stencil of ``args.preset`` (none: leave them)."""
    if not args.preset:
        return
    if (args.nx, args.ny, args.nz, args.stencil) != (100, 100, 100, 27):
        print("# --preset overrides --nx/--ny/--nz/--stencil", file=sys.stderr)
    side, args.stencil = PRESETS[args.preset]
    args.nx = args.ny = args.nz = side


def power_limit_w(device: torch.device):
    """The card's power limit in W as nvidia-smi reports it; None on the
    CPU."""
    if device.type != "cuda":
        return None
    out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60, check=True)
    lines = out.stdout.strip().splitlines()
    index = device.index if device.index is not None else torch.cuda.current_device()
    return float(lines[index if index < len(lines) else 0])


def _spmv_seconds(op, u0, device) -> float:
    """Seconds per K1 launch: a ping-pong between two buffers, slope-timed
    between SPMV_LEGS launches (one CUDA graph per leg on the card, so the
    host's launch rate is not what is timed)."""
    from hpccg_tpu_torch.ops.cuda.stencil import spmv_stencil
    from hpccg_tpu_torch.utils.timing import graph_legs, time_loop_slope

    bufs = [u0.clone(), torch.empty_like(u0)]

    def loop(k):
        for i in range(k):
            spmv_stencil(op, bufs[i % 2], out=bufs[(i + 1) % 2])

    short, long = SPMV_LEGS
    return time_loop_slope(graph_legs(loop, SPMV_LEGS, device), device=device, short=short, long=long)


def run(args) -> dict:
    """The benchmark; returns the JSON line's object."""
    from hpccg_tpu_torch import ProblemConfig, generate_problem
    from hpccg_tpu_torch.solver import make_cg, resolve_backend
    from hpccg_tpu_torch.utils.bandwidth import measure
    from hpccg_tpu_torch.utils.timing import elapsed, fence, time_loop_slope

    device = torch.device(args.device)
    dtype = DTYPES[args.dtype]
    cfg = ProblemConfig(args.nx, args.ny, args.nz, stencil=args.stencil, dtype=dtype)
    prob = generate_problem(cfg, device)
    backend = resolve_backend(args.backend, device, dtype)

    def solver(max_iter):
        return make_cg(prob.A, max_iter=max_iter, tolerance=0.0, backend=backend)

    # slope timing: the fixed cost of a solve (set-up, launches, the final
    # read-back) cancels between the two legs; interleaved pairs share one
    # clock epoch of the card. A tiny problem can reach an exactly zero
    # residual and leave the tolerance-0 loop early: the slope is taken over
    # the iterations that ran, provided the legs still differ enough.
    k1, k2 = SHORT_ITERS, max(args.max_iter - 1, LONG_ITERS[device.type])
    short, long = solver(k1 + 1), solver(k2 + 1)
    k1_real, k2_real = (int(s(prob.b, prob.x0).niters) for s in (short, long))
    if k2_real < 2 * k1_real:
        raise SystemExit(f"error: the long leg exited too early for slope timing ({k2_real} vs {k1_real} "
                         "iterations); use a larger problem")
    legs = {k1_real: short, k2_real: long}
    per_iter = time_loop_slope(lambda k: legs[k](prob.b, prob.x0), device=device, short=k1_real, long=k2_real,
                               reps=args.reps)
    per_iter = max(per_iter, 1e-12)

    # the headline solve itself, end to end: the fastest of --reps
    solve = solver(args.max_iter)
    solve(prob.b, prob.x0)
    fence(device)
    times, out = [], []
    for _ in range(args.reps):
        times.append(elapsed(lambda: out.append(solve(prob.b, prob.x0)), device))
    res = out[-1]

    t_spmv = _spmv_seconds(prob.A, prob.A.grid(prob.b), device)
    bw = measure(device, None if device.type == "cuda" else CPU_PROBE_BYTES)

    nnz_model = prob.total_nnz_model
    nnz_per_s = nnz_model / per_iter
    spmv_bytes = 2 * prob.total_nrow * prob.b.element_size()  # read u, write y
    flops_per_iter = (4.0 + 6.0) * prob.total_nrow + 2.0 * nnz_model  # main.cpp:224-227
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    return {
        "metric": "CG SpMV throughput (stencil*n nnz model), single device",
        "value": nnz_per_s / 1e9,
        "unit": "Gnnz/s",
        "vs_baseline": nnz_per_s / (bw.copy_gbps * 1e9 / 12.0),
        "extras": {
            "device": kind,
            "power_limit_w": power_limit_w(device),
            "backend": backend,
            "problem": f"{args.nx}x{args.ny}x{args.nz} {args.stencil}-pt {args.dtype}",
            "niters": int(res.niters),
            "cg_iter_us": per_iter * 1e6,
            "spmv_us": t_spmv * 1e6,
            "spmv_gbps_2pass": spmv_bytes / t_spmv / 1e9 if t_spmv > 0 else float("inf"),
            "spmv_gnnz_per_s": nnz_model / t_spmv / 1e9 if t_spmv > 0 else float("inf"),
            "cg_iters_per_s": 1.0 / per_iter,
            "solve_e2e_s": min(times),
            "mflops_model": flops_per_iter / per_iter / 1e6,
            "final_normr": float(res.normr),
            "hbm_copy_gbps": bw.copy_gbps,
            "hbm_write_gbps": bw.write_gbps,
            "timing": (f"slope between {k1 + 1}- and {k2 + 1}-iteration solves, median of {max(args.reps, 3)} "
                       f"interleaved pairs, {'CUDA events' if device.type == 'cuda' else 'host clock'}; "
                       f"spmv_us: K1 slope between {SPMV_LEGS[0]} and {SPMV_LEGS[1]} launches"),
            "other_paths": OTHER_PATHS,
            "vs_baseline_def": (f"ours / (B/12 B-per-nnz), the reference CSR format's speed of light, with B = "
                                f"hbm_copy_gbps, the copy rate of {bw.nbytes} B arrays measured on this device "
                                f"({kind}) by the probe kernels at run time"),
        },
    }


def main(argv=None) -> int:
    # a hang (a wedged card) becomes a traceback and an exit, not
    # a run that never ends
    import faulthandler
    import os

    try:
        watchdog_s = float(os.environ.get("BENCH_WATCHDOG_S", "2400") or 0)
    except ValueError:
        print("# BENCH_WATCHDOG_S is not a number; using the 2400 s default", file=sys.stderr)
        watchdog_s = 2400.0
    if watchdog_s > 0:
        faulthandler.dump_traceback_later(watchdog_s, exit=True)
    try:
        args = build_argparser().parse_args(argv)
        apply_preset(args)
        if args.device == "cuda" and not torch.cuda.is_available():
            print("error: no CUDA device available; pass --device cpu to run on the CPU", file=sys.stderr)
            return 2
        print(json.dumps(run(args)))
        return 0
    finally:
        if watchdog_s > 0:
            faulthandler.cancel_dump_traceback_later()


if __name__ == "__main__":
    sys.exit(main())
