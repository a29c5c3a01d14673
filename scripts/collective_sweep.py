"""Time the collective whole solves K15 (cg, cg1) and K16 (pipecg) at several
launch bounds and protocol options on the card, and the variant that does no
vector work.

    python3 scripts/collective_sweep.py [VARIANT ...]

A VARIANT sets the constants of ``csrc/collective.cu``, e.g. ``b3-p2``
(the build's defaults): B and P, the most blocks resident on an SM (the
kernel's launch bound) for cg and cg1 and for pipecg. Optional
parts: ``-zcN`` sets HPCCG_COLL_ZC (the largest z chunk of a work item),
``-table`` keeps the
allreduce's table round at one rank (HPCCG_COLL_ONE_RANK=0), and a
``-sync`` suffix builds the variant with ``HPCCG_COLL_SYNC_ONLY=1``: its
passes do no vector work, so a solve is the protocol alone (barriers,
exchanges, allreduces with their partial sums). Without arguments it sweeps
the defaults below. Each variant is a copy of ``hpccg_tpu_torch/`` and
``chip_smoke.py`` under ``build/collective_sweep/`` whose
``csrc/collective.cu`` starts with the ``#define HPCCG_COLL_*`` lines; the
copies are built three at a time first. Then each variant runs in its own
process, in the order given and again in reverse, and prints slope-timed
us per CG iteration (CUDA events, legs of 17 and 97 iterations) of cg,
cg1 and pipecg, 27-point, at 1 x 100^3 in float32 and bfloat16, 4 x 100^3
in float32 and 8 x 64^3 in float32 and bfloat16, every rank on the one
card, with each launch's grid, and the registers and spills of each
instance. A full variant first holds each method against its plain version
on 2 x 33x17x9 float32 and bfloat16 (niters and the trace). Runs on a CUDA
card only.
"""

from __future__ import annotations

import re
import subprocess
import sys

from stencil_tile_sweep import ROOT, build_and_time, copy_with_defines

OUT = ROOT / "build" / "collective_sweep"
DEFAULTS = ["b3-p2", "b2-p3", "b4-p2", "b3-p2-table", "b3-p2-sync", "b3-p2-table-sync"]

# run in each copy's own process, with the copy as the working directory
TIMER = """import sys, torch
sys.path.insert(0, ".")
import chip_smoke as cs
from hpccg_tpu_torch import ProblemConfig
from hpccg_tpu_torch.ops.cuda import collective as col
from hpccg_tpu_torch.parallel import generate_problem_sharded
from hpccg_tpu_torch.parallel.cg import local_operator
from hpccg_tpu_torch.utils.timing import time_loop_slope
sync_only = "HPCCG_COLL_SYNC_ONLY 1" in open("hpccg_tpu_torch/csrc/collective.cu").read()
f32, bf16 = torch.float32, torch.bfloat16
if not sync_only:
    for dtype in (f32, bf16):
        cfg = ProblemConfig(33, 17, 9, dtype=dtype)
        op, prob = local_operator(cfg), generate_problem_sharded(cfg, cs._one_card(2))
        for method in ("cg", "cg1", "pipecg"):
            got = cs._coll_kernel(method)(op, prob.b, prob.x0, max_iter=5)
            want = col.solve_plain(op, prob.b, prob.x0, method=method, max_iter=5)
            rel = float(((got.trace[:5] - want.trace[:5]).abs() / want.trace[:5]).max())
            assert int(got.niters) == int(want.niters) and rel <= 1.5e-2, (method, dtype, rel)
line = []
for ndev, dims, dtype in ((1, 100, f32), (1, 100, bf16), (4, 100, f32), (8, 64, f32), (8, 64, bf16)):
    cfg = ProblemConfig(dims, dims, dims, dtype=dtype)
    op, prob = local_operator(cfg), generate_problem_sharded(cfg, cs._one_card(ndev))
    out = []
    for method in ("cg", "cg1", "pipecg"):
        kern = cs._coll_kernel(method)
        g = col.geometry(op, ndev, dtype, method)
        t = time_loop_slope(lambda k: kern(op, prob.b, prob.x0, max_iter=k + 1), device="cuda", short=17, long=97)
        out.append(f"{method} {t * 1e6:.2f} (zc {g.z_chunk}, {g.items}/{g.blocks_per_rank})")
    line.append(f"{ndev} x {dims}^3 {str(dtype)[6:]}: " + ", ".join(out))
print(("sync only: " if sync_only else "") + "; ".join(line) + " us/iter")
# registers and spill stores of each instance (ptxas -v), e.g. "f32 27pt cg: 80 regs, 76 B spilled"
import re
kern = None
for text in open("build/hpccg_tpu_torch/nvcc.log").read().splitlines():
    m = re.search(r"Compiling entry function '.*collective_kernelI(13__nv_bfloat16f|ff|dd)Li(\\d+)ELi(\\d)E", text)
    if m:
        kern = f"{ {'13__nv_bfloat16f': 'bf16', 'ff': 'f32', 'dd': 'f64'}[m[1]] } {m[2]}pt {['cg', 'cg1', 'pipecg'][int(m[3])]}"
    elif kern and "spill stores" in text:
        spill = int(re.search(r"(\\d+) bytes spill stores", text).group(1))
    elif kern and "Used" in text:
        print(f"  {kern}: {re.search(r'Used (\\d+) registers', text).group(1)} regs, {spill} B spilled")
        kern = None
"""


def parse(variant: str) -> dict:
    m = re.fullmatch(r"b(\d+)-p(\d+)(?:-zc(\d+))?(-table)?(-sync)?", variant)
    if m is None:
        raise SystemExit(f"bad variant {variant!r}: expected e.g. b3-p2, b3-p2-zc16, b3-p2-table-sync")
    defines = {"HPCCG_COLL_BLOCKS": int(m[1]), "HPCCG_COLL_BLOCKS_PIPE": int(m[2]),
               "HPCCG_COLL_ONE_RANK": int(not m[4]), "HPCCG_COLL_SYNC_ONLY": int(bool(m[5]))}
    if m[3] is not None:
        defines["HPCCG_COLL_ZC"] = int(m[3])
    return defines


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()


def main(argv) -> int:
    order = list(argv) or DEFAULTS
    print(f"card: {card()}", flush=True)
    dirs = {v: copy_with_defines(OUT / v, "collective.cu", parse(v)) for v in dict.fromkeys(order)}
    build_and_time(dirs, order, TIMER)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
