#!/usr/bin/env python3
"""Smoke check of the PyTorch/CUDA port (hpccg_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and exits non-zero:

1. device: needs torch.cuda; prints the card's name and power limit
   (nvidia-smi), the torch/CUDA versions and nvcc's version;
2. build: compiles the kernel library from hpccg_tpu_torch/csrc with nvcc;
3. kernel vs plain: K1 (with and without halos), K2, K3, K4 and the
   finalize step against their plain torch versions on the card, at
   33x17x9, 100^3 and 64x48x130, 27- and 7-point, float32 and float64;
   then K1 and K4 past 2^31 points (64-bit offsets);
4. main path: make_cg on the generated 100^3 27-point float32 problem,
   max_iter 150, tolerance 0, on auto (= pallas_fused), pallas and stencil,
   with every kernel's launch count read from that run; then 256^3 at
   max_iter 50;
5. golden: the reference's 10^3 float64 run on pallas_fused;
6. CLI: ``python -m hpccg_tpu_torch 100 100 100 --dtype float32 --json``;
7. timing: slope-timed us per CG iteration for each backend at 100^3 and
   256^3 float32 (CUDA events, legs of 65 and 1025 iterations), and K1
   against the plain matvec. Nothing is asserted on times.

The line before the last is the kernels' JSON; the last line is
``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import subprocess
import sys
import time

import torch

# kernel -> (source, the TPU kernel it replaces)
KERNELS = {
    "K1 stencil spmv": ("hpccg_tpu_torch/csrc/stencil.cu", "hpccg_tpu/ops/pallas/stencil_v2.py:133"),
    "K2 stencil spmv + p.Ap": ("hpccg_tpu_torch/csrc/stencil.cu", "hpccg_tpu/ops/pallas/stencil_v2.py:280"),
    "K3 p-update + spmv + p.Ap": ("hpccg_tpu_torch/csrc/stencil.cu", "hpccg_tpu/ops/pallas/fused_cg.py:68"),
    "K4 x/r update + r.r": ("hpccg_tpu_torch/csrc/fused_cg.cu", "hpccg_tpu/ops/pallas/fused_cg.py:114"),
    "finalize (partials + CG scalars)": ("hpccg_tpu_torch/csrc/fused_cg.cu", "hpccg_tpu/ops/pallas/fused_cg.py:107"),
}
# tolerances, kernel vs plain on the same inputs: the sums run in another
# order (the xy-sums associate like the plain version, but the compiler may
# contract into FMAs, and the dots are per-block trees)
VEC_RTOL = {torch.float32: 1e-5, torch.float64: 1e-13}  # max|a-b| / max|b|
DOT_RTOL = {torch.float32: 1e-4, torch.float64: 1e-12}  # |a-b| / |b|
SHAPES = [(33, 17, 9), (100, 100, 100), (64, 48, 130)]
MAIN_SHAPE = (100, 100, 100)


def say(msg: str) -> None:
    print(msg, flush=True)


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda is not available; this check needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    card = smi.stdout.strip().splitlines()[0]
    say(card)
    say(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} devices {torch.cuda.device_count()}")
    from hpccg_tpu_torch.ops.cuda.build import nvcc_path

    ver = subprocess.run([nvcc_path(), "--version"], capture_output=True, text=True, timeout=60)
    say(f"[device] nvcc: {ver.stdout.strip().splitlines()[-1]}")
    return card


def phase_build() -> None:
    from hpccg_tpu_torch.ops.cuda import build

    t0 = time.perf_counter()
    compiled = build.build()
    build.load_library()
    say(f"[build] nvcc {compiled:.1f} s (load {time.perf_counter() - t0:.1f} s) -> "
        f"{build.BUILD_DIR / build.LIB_NAME}")
    for line in (build.BUILD_DIR / "nvcc.log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            say(f"[build] {line.strip()}")


def _vec_err(a, b, dtype, what):
    err = float((a - b).abs().max())
    scale = float(b.abs().max()) or 1.0
    if not err <= VEC_RTOL[dtype] * scale:
        raise AssertionError(f"{what}: max|kernel - plain| = {err:.3e} > {VEC_RTOL[dtype]} * {scale:.3e}")
    return err


def _dot_err(a, b, dtype, what):
    a, b = float(a), float(b)
    if not abs(a - b) <= DOT_RTOL[dtype] * abs(b):
        raise AssertionError(f"{what}: kernel {a!r} vs plain {b!r} (rtol {DOT_RTOL[dtype]})")
    return abs(a - b)


def _device_ms(fn, reps=20) -> float:
    """Device time per call of fn: the sum of the card's kernel durations
    that torch.profiler records over ``reps`` calls. (CUDA events around
    back-to-back calls would time the host instead: each wrapper call costs
    more host time than a 100^3 kernel takes on the card.)"""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total_us = sum(
        getattr(ev, "device_time_total", 0.0)
        for ev in prof.key_averages()
        if ev.device_type == torch.autograd.DeviceType.CUDA
    )
    if total_us <= 0:
        raise AssertionError("torch.profiler recorded no device time")
    return total_us / 1e3 / reps


def phase_kernels() -> dict:
    """Kernel vs plain; returns per-kernel max_abs_err/ms/plain_ms at the
    main path's shape (100^3, 27-point, float32)."""
    from hpccg_tpu_torch.config import Stencil
    from hpccg_tpu_torch.operators import StencilOperator
    from hpccg_tpu_torch.ops.cuda import fused_cg as fc
    from hpccg_tpu_torch.ops.cuda import stencil as st

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1234)
    stats = {name: {"max_abs_err": 0.0} for name in KERNELS}
    names = list(KERNELS)
    for nx, ny, nz in SHAPES:
        for stencil in (Stencil.S27, Stencil.S7):
            for dtype in (torch.float32, torch.float64):
                op = StencilOperator(nx, ny, nz, stencil, dtype)
                tag = f"{nx}x{ny}x{nz} {stencil.value}pt {str(dtype)[6:]}"
                main = (nx, ny, nz) == MAIN_SHAPE and stencil == Stencil.S27 and dtype == torch.float32

                def rnd(*shape):
                    return torch.randn(shape, generator=gen, device=dev, dtype=dtype)

                grid = (nz, ny, nx)
                u, r, p = rnd(*grid), rnd(*grid), rnd(*grid)
                halo2, halo4 = rnd(2, ny, nx), rnd(4, ny, nx)
                beta = torch.tensor([0.37], device=dev, dtype=dtype)
                errs = {}
                # K1, without and with external halo planes
                e = 0.0
                for halo in (None, halo2):
                    e = max(e, _vec_err(st.spmv_stencil(op, u, halo), st.spmv_stencil_plain(op, u, halo),
                                        dtype, f"K1 {tag} halo={halo is not None}"))
                errs[names[0]] = e
                # K2
                y, parts = st.spmv_stencil_pap(op, u, halo2)
                y0, parts0 = st.spmv_stencil_pap_plain(op, u, halo2)
                errs[names[1]] = _vec_err(y, y0, dtype, f"K2 y {tag}")
                _dot_err(parts.sum(), parts0.sum(), dtype, f"K2 p.Ap {tag}")
                # K3, with a nonzero beta, with and without halos
                e = 0.0
                for halo in (None, halo4):
                    pp, ap, parts = st.update_p_apply(op, r, p, beta, halo)
                    pp0, ap0, parts0 = st.update_p_apply_plain(op, r, p, beta, halo)
                    e = max(e, _vec_err(pp, pp0, dtype, f"K3 p' {tag}"),
                            _vec_err(ap, ap0, dtype, f"K3 Ap' {tag}"))
                    _dot_err(parts.sum(), parts0.sum(), dtype, f"K3 p'.Ap' {tag}")
                errs[names[2]] = e
                # K4 (in place: both versions get their own copies)
                alpha = torch.tensor([0.21], device=dev, dtype=dtype)
                ap = rnd(*grid)
                x1, r1, x2, r2 = u.clone(), r.clone(), u.clone(), r.clone()
                _, _, parts = fc.update_x_r(x1, r1, p, ap, alpha)
                _, _, parts0 = fc.update_x_r_plain(x2, r2, p, ap, alpha)
                errs[names[3]] = max(_vec_err(x1, x2, dtype, f"K4 x' {tag}"),
                                     _vec_err(r1, r2, dtype, f"K4 r' {tag}"))
                _dot_err(parts.sum(), parts0.sum(), dtype, f"K4 r'.r' {tag}")
                # finalize: the same step sequence on two copies of a state
                errs[names[4]] = _check_finalize(fc, dtype, dev, gen, tag)
                if main:
                    for name in names:
                        stats[name]["max_abs_err"] = errs[name]
                    _time_kernels(st, fc, op, u, r, p, beta, stats, names)
                say(f"[kernels] {tag}: ok " + " ".join(f"{n.split()[0]}={errs[n]:.2e}" for n in names))
    return stats


def phase_large_offsets() -> None:
    """K1 and K4 past 2^31 elements (64-bit offsets): the top planes and the
    last elements against the plain versions on slices."""
    from hpccg_tpu_torch.operators import StencilOperator
    from hpccg_tpu_torch.ops.cuda import fused_cg as fc
    from hpccg_tpu_torch.ops.cuda import stencil as st

    nx, ny, nz = 1024, 1024, 2049  # 2,148,532,224 points > 2^31
    gen = torch.Generator(device="cuda").manual_seed(7)
    op = StencilOperator(nx, ny, nz)
    u = torch.rand((nz, ny, nx), generator=gen, device="cuda", dtype=torch.float32)
    y = st.spmv_stencil(op, u)
    top = StencilOperator(nx, ny, 3)
    want = st.spmv_stencil_plain(top, u[-3:].contiguous(), torch.stack([u[-4], torch.zeros_like(u[0])]))
    err = _vec_err(y[-3:], want, torch.float32, "K1 past 2^31")
    del y
    n = u.numel()
    x, r = u.view(-1), torch.rand((n,), generator=gen, device="cuda", dtype=torch.float32)
    p = r.flip(0)
    alpha = torch.tensor([0.5], device="cuda")
    tail = slice(n - 4096, n)
    x0, r0, p0 = x[tail].clone(), r[tail].clone(), p[tail].clone()
    fc.update_x_r(x, r, p, p, alpha)
    fc.update_x_r_plain(x0, r0, p0, p0, alpha)
    err = max(err, _vec_err(x[tail], x0, torch.float32, "K4 x past 2^31"),
              _vec_err(r[tail], r0, torch.float32, "K4 r past 2^31"))
    torch.cuda.synchronize()
    say(f"[kernels] {nx}x{ny}x{nz} f32 ({n} points, past 2^31): K1 top planes and K4 tail ok, "
        f"max err {err:.2e}")


def _check_finalize(fc, dtype, dev, gen, tag) -> float:
    states = [fc.CGScalars.new(dtype, 6, 1e-30, dev) for _ in range(2)]
    err = 0.0
    steps = [fc.STEP_INIT] + [fc.STEP_PAP, fc.STEP_RR] * 6  # runs past the exit
    for i, step in enumerate(steps):
        parts = torch.rand((700,), generator=gen, device=dev, dtype=dtype) + 0.5
        fc.cg_finalize(parts, states[0], step)
        fc.cg_finalize_plain(parts, states[1], step)
        a, b = states
        if not torch.equal(a.ic, b.ic):
            raise AssertionError(f"finalize {tag} step {i}: ic {a.ic.tolist()} vs {b.ic.tolist()}")
        if not torch.equal(torch.isnan(a.trace), torch.isnan(b.trace)):
            raise AssertionError(f"finalize {tag} step {i}: trace {a.trace.tolist()} vs {b.trace.tolist()}")
        fin = ~torch.isnan(b.trace)
        err = max(err, _vec_err(a.sc, b.sc, dtype, f"finalize sc {tag} step {i}"),
                  _vec_err(a.trace[fin], b.trace[fin], dtype, f"finalize trace {tag} step {i}"))
    if int(states[0].ic[fc.IC_ACTIVE]) != 0 or int(states[0].ic[fc.IC_K]) != 6:
        raise AssertionError(f"finalize {tag}: expected an exit at k=6, got ic={states[0].ic.tolist()}")
    return err


def _time_kernels(st, fc, op, u, r, p, beta, stats, names) -> None:
    out, out2 = torch.empty_like(u), torch.empty_like(u)
    parts3 = torch.empty((st.num_partials(op, u.device),), device=u.device, dtype=u.dtype)
    pairs = {
        names[0]: (lambda: st.spmv_stencil(op, u, out=out), lambda: st.spmv_stencil_plain(op, u, out=out)),
        names[1]: (lambda: st.spmv_stencil_pap(op, u, out=out, partials=parts3),
                   lambda: st.spmv_stencil_pap_plain(op, u, out=out)),
        names[2]: (lambda: st.update_p_apply(op, r, p, beta, out_p=out, out_ap=out2, partials=parts3),
                   lambda: st.update_p_apply_plain(op, r, p, beta, out_p=out, out_ap=out2)),
    }
    x, rr, ap = u.clone(), r.clone(), p.clone()
    alpha = torch.zeros((1,), device=u.device, dtype=u.dtype)  # keeps x, r unchanged
    parts4 = torch.empty((fc.num_update_partials(x.numel(), x.device),), device=x.device, dtype=x.dtype)
    pairs[names[3]] = (lambda: fc.update_x_r(x, rr, p, ap, alpha, partials=parts4),
                       lambda: fc.update_x_r_plain(x, rr, p, ap, alpha))
    state = fc.CGScalars.new(u.dtype, 10**9, 0.0, u.device)
    fc.cg_finalize(parts3, state, fc.STEP_INIT)
    pairs[names[4]] = (lambda: fc.cg_finalize(parts3, state, fc.STEP_PAP),
                       lambda: fc.cg_finalize_plain(parts3, state, fc.STEP_PAP))
    for name, (kern, plain) in pairs.items():
        # plain, kernel, kernel, plain: the two versions share the card's state
        t_plain1, t_k1, t_k2, t_plain2 = (_device_ms(f) for f in (plain, kern, kern, plain))
        stats[name]["ms"] = (t_k1 + t_k2) / 2
        stats[name]["plain_ms"] = (t_plain1 + t_plain2) / 2


def _counts():
    from hpccg_tpu_torch.ops.cuda import fused_cg as fc
    from hpccg_tpu_torch.ops.cuda import stencil as st

    wrappers = [st.spmv_stencil, st.spmv_stencil_pap, st.update_p_apply, fc.update_x_r, fc.cg_finalize]
    return dict(zip(KERNELS, wrappers))


def _trace_check(tr, ref, what, rtol=1e-4, floor=1e-7):
    """Trace against stencil's: within rtol while the residual is above
    floor * trace[0], about float32's epsilon, where the true residual
    stagnates; below it the recurrence residual follows the rounding of
    each run (measured: two runs part by 1e-4 somewhere between 1e-8 and
    1e-11 of trace[0]) and only its order of magnitude is held, as in the
    golden run's log-tail check."""
    n = min(len(tr), len(ref))
    tr, ref = tr[:n], ref[:n]
    rel = (tr - ref).abs() / ref.abs()
    head = ref > floor * ref[0]
    worst = float(rel[head].max())
    if not worst <= rtol:
        k = int(torch.nonzero(head & (rel > rtol))[0])
        raise AssertionError(f"{what}: trace differs from stencil's by {worst:.3e} (first at k={k}, "
                             f"{float(tr[k])!r} vs {float(ref[k])!r})")
    decades = (tr[~head].log10() - ref[~head].log10()).abs()
    limit = 0.05 * ref[~head].log10().abs() + 1.0
    if bool((decades > limit).any()):
        raise AssertionError(f"{what}: trace tail off by {float(decades.max()):.2f} decades")
    tail = float(rel[~head].max()) if bool((~head).any()) else 0.0
    return worst, tail


def _solve_all(dims, max_iter, backends):
    """The main path through the user's entry points; returns traces and the
    launch counts of each backend's run."""
    from hpccg_tpu_torch import ProblemConfig, generate_problem, make_cg

    prob = generate_problem(ProblemConfig(*dims, stencil=27, dtype=torch.float32), device="cuda")
    out = {}
    wrappers = _counts()
    for backend in backends:
        before = {n: w.launches for n, w in wrappers.items()}
        res = make_cg(prob.A, max_iter=max_iter, tolerance=0.0, backend=backend)(prob.b, prob.x0)
        torch.cuda.synchronize()
        niters, normr = int(res.niters), float(res.normr)
        delta = {n: w.launches - before[n] for n, w in wrappers.items()}
        if niters != max_iter - 1 or not math.isfinite(normr):
            raise AssertionError(f"{backend} {dims}: niters {niters}, normr {normr}")
        if not bool(torch.isfinite(res.x).all()):
            raise AssertionError(f"{backend} {dims}: non-finite x")
        out[backend] = (res.trace.double().cpu(), delta, res)
        say(f"[main] {dims} {backend}: niters {niters} normr {normr:.6e} "
            f"launches {json.dumps({n.split()[0]: d for n, d in delta.items()})}")
    return out


def phase_main_path() -> dict:
    names = list(KERNELS)
    wrappers = _counts()
    for w in wrappers.values():
        w.launches = 0
    runs = _solve_all(MAIN_SHAPE, 150, ["auto", "pallas", "stencil"])
    launches = {n: w.launches for n, w in wrappers.items()}
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"{name} was not launched on the main path")
    fused = runs["auto"][1]
    for n in (names[0], names[2], names[3], names[4]):
        if fused[n] <= 0:
            raise AssertionError(f"auto (pallas_fused) did not launch {n}")
    if runs["pallas"][1][names[1]] <= 0 or runs["pallas"][1][names[4]] <= 0:
        raise AssertionError("pallas did not launch K2 and finalize")
    if any(runs["stencil"][1].values()):
        raise AssertionError("the stencil backend launched a kernel")
    ref = runs["stencil"][0]
    for backend in ("auto", "pallas"):
        worst, tail = _trace_check(runs[backend][0], ref, f"{backend} 100^3")
        say(f"[main] 100^3 {backend}: trace within {worst:.2e} of stencil's above 1e-7 of "
            f"trace[0], {tail:.2e} below")
    again = _solve_all(MAIN_SHAPE, 150, ["pallas_fused"])["pallas_fused"][0]
    if not torch.equal(again, runs["auto"][0]):
        raise AssertionError("two pallas_fused solves gave different traces")
    say("[main] two pallas_fused solves: bit-identical traces")
    big = _solve_all((256, 256, 256), 50, ["auto", "pallas", "stencil"])
    for backend in ("auto", "pallas"):
        worst, tail = _trace_check(big[backend][0], big["stencil"][0], f"{backend} 256^3")
        say(f"[main] 256^3 {backend}: trace within {worst:.2e} of stencil's above 1e-7 of "
            f"trace[0], {tail:.2e} below")
    return launches


def phase_golden() -> None:
    from hpccg_tpu_torch import ProblemConfig, generate_problem, make_cg

    golden = {0: 258.24, 15: 2.15402e-06, 30: 2.81972e-20, 45: 6.66682e-30, 60: 7.96609e-39,
              75: 1.85259e-48, 90: 1.15032e-56, 105: 1.01621e-65, 120: 1.39759e-75,
              135: 1.07273e-83, 149: 1.68304e-92}  # the reference's out.txt, 10^3
    prob = generate_problem(ProblemConfig(10, 10, 10, dtype=torch.float64), device="cuda")
    res = make_cg(prob.A, max_iter=150, tolerance=0.0, backend="pallas_fused")(prob.b, prob.x0)
    trace = res.trace.cpu().numpy()
    if int(res.niters) != 149:
        raise AssertionError(f"golden: niters {int(res.niters)}")
    if abs(trace[0] - golden[0]) > 1e-5 * golden[0] or abs(trace[15] - golden[15]) > 1e-4 * golden[15]:
        raise AssertionError(f"golden: trace[0] {trace[0]!r}, trace[15] {trace[15]!r}")
    for k, ref in golden.items():
        if k > 15 and not abs(math.log10(trace[k]) - math.log10(ref)) < 0.05 * abs(math.log10(ref)) + 1.0:
            raise AssertionError(f"golden: trace[{k}] {trace[k]!r} vs {ref!r}")
    say(f"[golden] 10^3 float64 pallas_fused: niters 149, trace[0] {trace[0]:.6g}, "
        f"trace[15] {trace[15]:.6g}, trace[149] {trace[149]:.6g}")


def phase_cli() -> None:
    from hpccg_tpu_torch.cli import main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(["100", "100", "100", "--dtype", "float32", "--json"])
    if rc != 0:
        raise AssertionError(f"cli returned {rc}")
    text = buf.getvalue()
    report = json.loads(text[text.index("\n{") + 1 :])  # after the residual lines
    say(f"[cli] rc 0, iterations {report['Number of iterations']}, "
        f"time summary {json.dumps(report['Time Summary'])}")


def phase_timing(card: str) -> None:
    from hpccg_tpu_torch import ProblemConfig, generate_problem, make_cg
    from hpccg_tpu_torch.ops.cuda.stencil import spmv_stencil, spmv_stencil_plain
    from hpccg_tpu_torch.utils.timing import time_loop_slope

    for dims in (MAIN_SHAPE, (256, 256, 256)):
        prob = generate_problem(ProblemConfig(*dims, stencil=27, dtype=torch.float32), device="cuda")
        n = prob.total_nrow
        for backend in ("stencil", "pallas", "pallas_fused"):
            last = []

            def run(k):
                last.append(make_cg(prob.A, max_iter=k + 1, tolerance=0.0, backend=backend)(prob.b, prob.x0))

            t = time_loop_slope(run, device="cuda", short=65, long=1025)
            say(f"[timing] {dims[0]}^3 f32 {backend}: {t * 1e6:.2f} us/iter, "
                f"{27 * n / t / 1e9:.1f} Gnnz/s (long-leg niters {int(last[-1].niters)}) [{card}]")
        u = prob.A.grid(prob.b)
        out = torch.empty_like(u)
        t_k = _device_ms(lambda: spmv_stencil(prob.A, u, out=out), reps=100)
        t_p = _device_ms(lambda: spmv_stencil_plain(prob.A, u, out=out), reps=100)
        say(f"[timing] {dims[0]}^3 f32 K1 {t_k * 1e3:.2f} us vs plain matvec {t_p * 1e3:.2f} us "
            f"({27 * n / (t_k / 1e3) / 1e9:.1f} vs {27 * n / (t_p / 1e3) / 1e9:.1f} Gnnz/s) [{card}]")


def main() -> int:
    card = phase_device()
    phase_build()
    stats = phase_kernels()
    phase_large_offsets()
    launches = phase_main_path()
    phase_golden()
    phase_cli()
    phase_timing(card)
    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": rep, "launches": launches[name],
         "max_abs_err": stats[name]["max_abs_err"], "ms": stats[name]["ms"],
         "plain_ms": stats[name]["plain_ms"]}
        for name, (src, rep) in KERNELS.items()
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
