"""Time the stencil kernels K1-K4, the CG backends on them, the whole
solves K5/K6 and the collective K15/K16, for two checkouts in turns on the
card, and compare their outputs.

    python3 scripts/stencil_ab.py PARENT_DIR [CHANGE_DIR]

PARENT_DIR and CHANGE_DIR (default: this checkout) are checkouts of the
repo, for example the parent commit unpacked with ``git archive`` into a
gitignored directory. Each reading runs in its own process with the
checkout as the working directory (its own kernel build), in the order
parent, change, change, parent, and prints:

- K1-K4 device time per launch (CUDA-graph replays,
  ``chip_smoke._graph_ms``), 27-point, in float32 at 100^3 and 256^3 and in
  bfloat16 at 256^3;
- slope-timed us per CG iteration (CUDA events, legs of 65 and 1025
  iterations) of ``pallas_fused`` (K3 without its Ap' store, K4s and two
  finalize steps an iteration) and of the whole solves ``megakernel`` (K5) and
  ``streamkernel`` (K6) at 100^3 and 256^3 float32 and 256^3 bfloat16;
- slope-timed us per iteration of K15 (cg) and K16 (pipecg) at 1 x 100^3
  float32 (legs of 17 and 97);
- whether two launches of K3 and K4 give the same bits, partials included.

Each process also saves K3's p' and Ap' (without and with halo planes) and
K4's x' and r' on one seeded input per dtype (100^3 float32, float64 and
bfloat16, 27- and 7-point), and the traces of 50-iteration K5 and K6
solves at 100^3 float32 and float64 and 256^3 bfloat16, under
``build/stencil_ab/``; the script then compares the first parent's and the
first change's saved outputs, and each checkout's two runs with each
other: K3/K4 outputs bit for bit, the traces within chip_smoke's
``WS_TRACE`` above its floor (two whole-solve kernels that sum their
partials in other orders are not bit-identical). Runs on a CUDA card only.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "stencil_ab"

# run in each checkout's own process, with the checkout as the working
# directory; argv[1] is the file that receives the saved outputs
TIMER = """import sys, torch
sys.path.insert(0, ".")
import chip_smoke as cs
from hpccg_tpu_torch import ProblemConfig, generate_problem, make_cg
from hpccg_tpu_torch.config import Stencil, scalar_dtype
from hpccg_tpu_torch.operators import StencilOperator
from hpccg_tpu_torch.ops.cuda import build, fused_cg as fc, stencil as st
from hpccg_tpu_torch.utils.timing import time_loop_slope
print("build s", round(build.build(), 1), flush=True)
f32, f64, bf16 = torch.float32, torch.float64, torch.bfloat16


def inputs(dims, stencil, dtype, seed):
    op = StencilOperator(*dims, stencil, dtype)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    grid = (dims[2], dims[1], dims[0])
    r, p, x, ap = (torch.randn(grid, generator=gen, device="cuda", dtype=f64).to(dtype) for _ in range(4))
    halo = torch.randn((4, dims[1], dims[0]), generator=gen, device="cuda", dtype=f64).to(dtype)
    sdt = scalar_dtype(dtype)
    beta, alpha = torch.tensor([0.37], device="cuda", dtype=sdt), torch.tensor([0.21], device="cuda", dtype=sdt)
    return op, r, p, x, ap, halo, beta, alpha


saved, same = {}, True
for dtype in (f32, f64, bf16):
    for stencil in (Stencil.S27, Stencil.S7):
        tag = f"100^3 {stencil.value}pt {str(dtype)[6:]}"
        op, r, p, x, ap, halo, beta, alpha = inputs((100, 100, 100), stencil, dtype, 5)
        for h in (None, halo):
            runs = [st.update_p_apply(op, r, p, beta, h) for _ in range(2)]
            same &= all(torch.equal(a.view(-1), b.view(-1)) for a, b in zip(*runs))
            hk = "" if h is None else " halo"
            saved[f"{tag}{hk} K3 p'"], saved[f"{tag}{hk} K3 Ap'"] = runs[0][0].cpu(), runs[0][1].cpu()
        runs = []
        for _ in range(2):
            x1, r1 = x.clone(), r.clone()
            runs.append(fc.update_x_r(x1, r1, p, ap, alpha))
        same &= all(torch.equal(a, b) for a, b in zip(*runs))
        saved[f"{tag} K4 x'"], saved[f"{tag} K4 r'"] = runs[0][0].cpu(), runs[0][1].cpu()
print("K3/K4 repeats bit-identical (partials included):", same, flush=True)

line = []
for dims, dtype in (((100,) * 3, f32), ((256,) * 3, f32), ((256,) * 3, bf16)):
    op, r, p, x, ap, _, beta, _ = inputs(dims, Stencil.S27, dtype, 6)
    out, out2 = torch.empty_like(r), torch.empty_like(r)
    sdt = scalar_dtype(dtype)
    parts3 = torch.empty((st.num_partials(op, "cuda"),), device="cuda", dtype=sdt)
    parts4 = torch.empty((fc.num_update_partials(r.numel(), "cuda"),), device="cuda", dtype=sdt)
    zero = torch.zeros((1,), device="cuda", dtype=sdt)  # keeps x and r as they are
    fns = {"K1": lambda: st.spmv_stencil(op, r, out=out),
           "K2": lambda: st.spmv_stencil_pap(op, r, out=out, partials=parts3),
           "K3": lambda: st.update_p_apply(op, r, p, beta, out_p=out, out_ap=out2, partials=parts3),
           "K4": lambda: fc.update_x_r(x, r, p, ap, zero, partials=parts4)}
    tag = f"{dims[0]}^3 {str(dtype)[6:]}"
    line.append(tag + ": " + " ".join(f"{k}={cs._graph_ms(fn) * 1e3:.2f}" for k, fn in fns.items()) + " us")
print("per launch:", "; ".join(line), flush=True)

for dims, dtype in (((100,) * 3, f32), ((100,) * 3, f64), ((256,) * 3, bf16)):
    prob = generate_problem(ProblemConfig(*dims, stencil=27, dtype=dtype), device="cuda")
    for backend in ("megakernel", "streamkernel"):
        res = make_cg(prob.A, max_iter=50, tolerance=0.0, backend=backend)(prob.b, prob.x0)
        saved[f"trace {dims[0]}^3 {str(dtype)[6:]} {backend}"] = res.trace.cpu()
torch.save(saved, sys.argv[1])

line = []
cells = [((100,) * 3, f32), ((256,) * 3, f32), ((256,) * 3, bf16)]
for dims, dtype in cells:
    prob = generate_problem(ProblemConfig(*dims, stencil=27, dtype=dtype), device="cuda")
    for backend in ("pallas_fused", "megakernel", "streamkernel"):
        def run(k):
            return make_cg(prob.A, max_iter=k + 1, tolerance=0.0, backend=backend)(prob.b, prob.x0)
        t = time_loop_slope(run, device="cuda", short=65, long=1025)
        line.append(f"{dims[0]}^3 {str(dtype)[6:]} {backend}={t * 1e6:.2f}")
print("us/iter:", " ".join(line), flush=True)

from hpccg_tpu_torch.parallel import generate_problem_sharded
from hpccg_tpu_torch.parallel.cg import local_operator
cfg = ProblemConfig(100, 100, 100, dtype=f32)
op, prob = local_operator(cfg), generate_problem_sharded(cfg, cs._one_card(1))
line = []
for name, method in (("K15 cg", "cg"), ("K16 pipecg", "pipecg")):
    kern = cs._coll_kernel(method)
    t = time_loop_slope(lambda k: kern(op, prob.b, prob.x0, max_iter=k + 1), device="cuda", short=17, long=97)
    line.append(f"{name}={t * 1e6:.2f}")
print("collective 1 x 100^3 float32 us/iter:", " ".join(line), flush=True)
"""


# the whole solves' traces: chip_smoke.WS_TRACE, (rtol, floor) per dtype
WS_TRACE = {"float32": (1e-4, 1e-5), "float64": (1e-10, 1e-11), "bfloat16": (1.5e-2, 1e-4)}


def trace_gap(x, y, dtype) -> tuple:
    """(worst relative gap of two traces above WS_TRACE's floor of x[0],
    the rtol it is held to)."""
    rtol, floor = WS_TRACE[dtype]
    x, y = x.double(), y.double()
    head = x > floor * x[0]
    return float(((x - y).abs() / x)[head].max()), rtol


def compare(a: dict, b: dict) -> str:
    """'bit-identical' (traces: 'within WS_TRACE') or the keys that differ
    (with the share of elements, or the trace gap)."""
    bad, gaps = [], []
    for key in a:
        x, y = a[key].reshape(-1), b[key].reshape(-1)
        if key.startswith("trace "):
            gap, rtol = trace_gap(x, y, key.split()[2])
            gaps.append(f"{' '.join(key.split()[1:])} {gap:.2e}")
            if not gap <= rtol:
                bad.append(f"{key} (gap {gap:.2e} > {rtol:g})")
            continue
        if not torch.equal(x.view(torch.int16) if x.dtype == torch.bfloat16 else x,
                           y.view(torch.int16) if y.dtype == torch.bfloat16 else y):
            bad.append(f"{key} ({float((x != y).float().mean()):.2e} of the elements)")
    what = "K3/K4 bit-identical, traces within WS_TRACE" if not bad else "DIFFER: " + "; ".join(bad)
    return what + " (trace gaps: " + ", ".join(gaps) + ")"


def main(argv) -> int:
    if not 1 <= len(argv) <= 2:
        raise SystemExit(__doc__)
    parent = Path(argv[0]).resolve()
    change = Path(argv[1]).resolve() if len(argv) > 1 else ROOT
    OUT.mkdir(parents=True, exist_ok=True)
    files = {}
    for i, (tag, cwd) in enumerate((("parent", parent), ("change", change), ("change", change),
                                    ("parent", parent))):
        path = OUT / f"{i}_{tag}.pt"
        proc = subprocess.run([sys.executable, "-c", TIMER, str(path)], cwd=cwd, capture_output=True, text=True,
                              timeout=900)
        print(f"--- {tag} (rc {proc.returncode})", flush=True)
        print(proc.stdout.strip() if proc.returncode == 0 else proc.stdout + proc.stderr[-3000:], flush=True)
        if proc.returncode == 0:
            files.setdefault(tag, []).append(torch.load(path))
    if len(files.get("parent", [])) != 2 or len(files.get("change", [])) != 2:
        print("outputs: not compared (a run failed)")
        return 1
    print("outputs, parent against change:", compare(files["parent"][0], files["change"][0]))
    print("outputs, parent's two runs:", compare(*files["parent"]))
    print("outputs, change's two runs:", compare(*files["change"]))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
