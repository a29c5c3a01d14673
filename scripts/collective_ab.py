"""Time the collective whole solves of two checkouts in turns on the card.

    python3 scripts/collective_ab.py PARENT_DIR [CHANGE_DIR]

PARENT_DIR and CHANGE_DIR (default: this checkout) are checkouts of the
repo, for example the parent commit unpacked with ``git archive`` into a
gitignored directory. Each reading runs in its own process with the
checkout as the working directory (its own kernel build), in the order
parent, change, change, parent, and prints slope-timed µs per iteration
(CUDA events, legs of 17 and 97 iterations; 17 and 145 for K17): K15 (cg,
cg1) and K16 (pipecg) at 1 x 100^3 in float32, and in bfloat16 where the
checkout's kernels take it, and K17 (cg, cg1) on the 128^3 DIA matrix on 4
ranks of one card. Runs on a CUDA card only.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

TIMER = """import sys, torch
sys.path.insert(0, ".")
import chip_smoke as cs
from hpccg_tpu_torch import ProblemConfig
from hpccg_tpu_torch.ops.cuda import build, collective as col
from hpccg_tpu_torch.parallel import generate_problem_sharded
from hpccg_tpu_torch.parallel.cg import local_operator
from hpccg_tpu_torch.utils.timing import time_loop_slope
print("build s", round(build.build(), 1))
out = {}
dtypes = [torch.float32] + ([torch.bfloat16] if "hpccg_collective_bf16" in (build.CSRC_DIR / "collective.cu").read_text() else [])
for dtype in dtypes:
    cfg = ProblemConfig(100, 100, 100, dtype=dtype)
    op, prob = local_operator(cfg), generate_problem_sharded(cfg, cs._one_card(1))
    for method in ("cg", "cg1", "pipecg"):
        kern = cs._coll_kernel(method)
        t = time_loop_slope(lambda k: kern(op, prob.b, prob.x0, max_iter=k + 1), device="cuda", short=17, long=97)
        out[f"{str(dtype)[6:]} {method}"] = t * 1e6
mesh = cs._one_card(4)
prob128, dia = cs._explicit_128(torch.float32)
sp = cs._sharded_file_problem(dia, mesh, prob128.b)
for method in ("cg", "cg1"):
    t = time_loop_slope(lambda k: col.cg_collective_dia(sp.A, sp.b, sp.x0, method=method, max_iter=k + 1),
                        device="cuda", short=17, long=145)
    out[f"K17 float32 {method}"] = t * 1e6
print(" ".join(f"{k}={v:.2f}" for k, v in out.items()))
"""


def main(argv) -> int:
    if not 1 <= len(argv) <= 2:
        raise SystemExit(__doc__)
    parent = Path(argv[0]).resolve()
    change = Path(argv[1]).resolve() if len(argv) > 1 else ROOT
    for tag, cwd in (("parent", parent), ("change", change), ("change", change), ("parent", parent)):
        proc = subprocess.run([sys.executable, "-c", TIMER], cwd=cwd, capture_output=True, text=True, timeout=900)
        print(f"--- {tag} (rc {proc.returncode})", flush=True)
        print(proc.stdout.strip() or proc.stderr[-3000:], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
