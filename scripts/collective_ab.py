"""Time the collective whole solves of two checkouts in turns on the card,
and compare K17's and K5's outputs.

    python3 scripts/collective_ab.py PARENT_DIR [CHANGE_DIR]

PARENT_DIR and CHANGE_DIR (default: this checkout) are checkouts of the
repo, for example the parent commit unpacked with ``git archive`` into a
gitignored directory. Each reading runs in its own process with the
checkout as the working directory (its own kernel build), in the order
parent, change, change, parent, and prints slope-timed µs per iteration
(CUDA events, legs of 17 and 97 iterations; 17 and 145 for K17 and K5):
K15 (cg, cg1) and K16 (pipecg) at 1 x 100^3 in float32 and bfloat16 (where
the checkout's kernels take it), at 4 x 100^3 and 8 x 64^3 in float32,
every rank on the one card; K17 (cg, cg1) on the 128^3 DIA matrix on 4
ranks of one card; and K5 (megakernel) at 100^3 float32 as a control.
Each process also saves the trace and x of a 50-iteration K17 solve (cg and
cg1) and of a 150-iteration K5 solve under ``build/collective_ab/``; the
script then says whether the first parent's and the first change's saved
outputs are bit for bit the same, and each checkout's two runs. Runs on a
CUDA card only.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "collective_ab"

# run in each checkout's own process, with the checkout as the working
# directory; argv[1] is the file that receives the saved outputs
TIMER = """import sys, torch
sys.path.insert(0, ".")
import chip_smoke as cs
from hpccg_tpu_torch import ProblemConfig, generate_problem, make_cg
from hpccg_tpu_torch.ops.cuda import build, collective as col
from hpccg_tpu_torch.parallel import generate_problem_sharded
from hpccg_tpu_torch.parallel.cg import local_operator
from hpccg_tpu_torch.utils.timing import time_loop_slope
print("build s", round(build.build(), 1), flush=True)
out, saved = {}, {}
bf16 = "hpccg_collective_bf16" in (build.CSRC_DIR / "collective.cu").read_text()
cells = [(1, 100, torch.float32)] + ([(1, 100, torch.bfloat16)] if bf16 else []) + [(4, 100, torch.float32),
                                                                                     (8, 64, torch.float32)]
for ndev, dims, dtype in cells:
    cfg = ProblemConfig(dims, dims, dims, dtype=dtype)
    op, prob = local_operator(cfg), generate_problem_sharded(cfg, cs._one_card(ndev))
    for method in ("cg", "cg1", "pipecg"):
        kern = cs._coll_kernel(method)
        t = time_loop_slope(lambda k: kern(op, prob.b, prob.x0, max_iter=k + 1), device="cuda", short=17, long=97)
        out[f"{ndev}x{dims}^3 {str(dtype)[6:]} {method}"] = t * 1e6
mesh = cs._one_card(4)
prob128, dia = cs._explicit_128(torch.float32)
sp = cs._sharded_file_problem(dia, mesh, prob128.b)
for method in ("cg", "cg1"):
    t = time_loop_slope(lambda k: col.cg_collective_dia(sp.A, sp.b, sp.x0, method=method, max_iter=k + 1),
                        device="cuda", short=17, long=145)
    out[f"K17 float32 {method}"] = t * 1e6
    res = col.cg_collective_dia(sp.A, sp.b, sp.x0, method=method, max_iter=50)
    saved[f"K17 {method}"] = (res.trace.cpu(), torch.cat(res.x).cpu())
g = generate_problem(ProblemConfig(100, 100, 100, dtype=torch.float32), "cuda")
t = time_loop_slope(lambda k: make_cg(g.A, max_iter=k + 1, backend="megakernel")(g.b, g.x0), device="cuda", short=17,
                    long=145)
out["K5 100^3 float32"] = t * 1e6
res = make_cg(g.A, max_iter=150, backend="megakernel")(g.b, g.x0)
saved["K5"] = (res.trace.cpu(), res.x.cpu())
torch.save(saved, sys.argv[1])
print(" ".join(f"{k}={v:.2f}" for k, v in out.items()))
"""


def compare(a: Path, b: Path) -> str:
    """Which saved outputs of two runs are bit for bit the same."""
    x, y = torch.load(a), torch.load(b)
    return ", ".join(f"{k} {'bit-identical' if all(torch.equal(u, v) for u, v in zip(x[k], y[k])) else 'DIFFERS'}"
                     for k in x)


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()


def main(argv) -> int:
    if not 1 <= len(argv) <= 2:
        raise SystemExit(__doc__)
    parent = Path(argv[0]).resolve()
    change = Path(argv[1]).resolve() if len(argv) > 1 else ROOT
    OUT.mkdir(parents=True, exist_ok=True)
    print(f"card: {card()}", flush=True)
    files = []
    for i, (tag, cwd) in enumerate((("parent", parent), ("change", change), ("change", change), ("parent", parent))):
        files.append(OUT / f"{i}_{tag}.pt")
        proc = subprocess.run([sys.executable, "-c", TIMER, str(files[-1])], cwd=cwd, capture_output=True, text=True,
                              timeout=900)
        print(f"--- {tag} (rc {proc.returncode})", flush=True)
        print(proc.stdout.strip() or proc.stderr[-3000:], flush=True)
    if all(f.exists() for f in files):
        print(f"parent vs change: {compare(files[0], files[1])}")
        print(f"change vs change: {compare(files[1], files[2])}; parent vs parent: {compare(files[0], files[3])}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
