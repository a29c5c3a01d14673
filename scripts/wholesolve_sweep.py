"""Time the whole-solve kernels K5 and K6 at several z chunks and blocks per
SM on the card, and the variant that does no vector work.

    python3 scripts/wholesolve_sweep.py [VARIANT ...]

A VARIANT sets the constants of ``csrc/wholesolve.cu``, e.g.
``zc32-b4-h2`` (the build's defaults): ZC, the largest z chunk of a work
item, B and H, the most blocks resident on an SM (the kernel's launch
bound) for float32/float64 and for bfloat16; an optional ``-dN`` sets
HPCCG_WS_DIRECT, the most (tile, plane) partials that every block adds
itself after a grid sync (``-d0``: the per-chunk tickets at every size).
A ``-sync``
suffix builds the variant with ``HPCCG_WS_SYNC_ONLY=1``: its phases do no
vector work, so a solve is the two grid syncs per iteration and the
partial sums alone. Without arguments it sweeps each constant around the
defaults and adds the sync-only build. Each variant is a copy of
``hpccg_tpu_torch/`` and ``chip_smoke.py`` under ``build/wholesolve_sweep/``
whose ``csrc/wholesolve.cu`` starts with the ``#define HPCCG_WS_*`` lines;
the copies are built three at a time first. Then each variant runs in its
own process, in the order given and again in reverse, and prints the grid
(z chunk, work items, blocks) and slope-timed us per CG iteration (CUDA
events, legs of 17 and 145 iterations) of K5 and K6, 27-point, at 100^3
and 256^3 in float32 and at 256^3 in bfloat16. A full variant first holds
K5 and K6 against their plain versions on a 64^3 float32 solve (niters and
the trace within 1e-4). Runs on a CUDA card only.
"""

from __future__ import annotations

import re
import sys

from stencil_tile_sweep import ROOT, build_and_time, copy_with_defines

OUT = ROOT / "build" / "wholesolve_sweep"
DEFAULTS = ["zc32-b4-h2", "zc16-b4-h2", "zc32-b3-h3", "zc32-b5-h4", "zc32-b4-h2-sync"]

# run in each copy's own process, with the copy as the working directory
TIMER = """import sys, torch
sys.path.insert(0, ".")
from hpccg_tpu_torch import ProblemConfig, generate_problem, make_cg
from hpccg_tpu_torch.ops.cuda import megakernel as mk, streamkernel as sk, wholesolve as ws
from hpccg_tpu_torch.utils.timing import time_loop_slope
sync_only = "HPCCG_WS_SYNC_ONLY 1" in open("hpccg_tpu_torch/csrc/wholesolve.cu").read()
if not sync_only:
    prob = generate_problem(ProblemConfig(64, 64, 64, dtype=torch.float32), device="cuda")
    for kern, plain in ((mk.cg_solve_mega, mk.cg_solve_mega_plain), (sk.cg_solve_stream, sk.cg_solve_stream_plain)):
        got, want = (f(prob.A, prob.b, prob.x0, max_iter=30) for f in (kern, plain))
        rel = float(((got.trace - want.trace).abs() / want.trace).max())
        assert int(got.niters) == int(want.niters) and rel <= 1e-4, (kern.__name__, rel)
line = []
for dims, dtype in (((100,) * 3, torch.float32), ((256,) * 3, torch.float32), ((256,) * 3, torch.bfloat16)):
    prob = generate_problem(ProblemConfig(*dims, dtype=dtype), device="cuda")
    for backend, stream in (("megakernel", False), ("streamkernel", True)):
        g = ws.geometry(prob.A, dtype, stream)
        t = time_loop_slope(lambda k: make_cg(prob.A, max_iter=k + 1, tolerance=0.0, backend=backend)(prob.b, prob.x0),
                            device="cuda", short=17, long=145)
        line.append(f"{dims[0]}^3 {str(dtype)[6:]} {backend} (zc {g.z_chunk}, {g.items} items, {g.blocks} blocks) "
                    f"{t * 1e6:.2f}")
print(("sync only: " if sync_only else "") + "; ".join(line) + " us/iter")
# registers and spill stores of each instance (ptxas -v), e.g. "float 27 false: 64 regs, 20 B spilled"
import re
kern = None
for text in open("build/hpccg_tpu_torch/nvcc.log").read().splitlines():
    m = re.search(r"Compiling entry function '.*wholesolve_kernelI(\\w+?)fLi(\\d+)ELb(\\d)|"
                  r"Compiling entry function '.*wholesolve_kernelI(\\w)\\wLi(\\d+)ELb(\\d)", text)
    if m:
        g = [x for x in m.groups() if x is not None]
        kern = f"{ {'13__nv_bfloat16': 'bf16', 'f': 'f32', 'd': 'f64'}.get(g[0], g[0]) } {g[1]}pt {'K6' if g[2] == '1' else 'K5'}"
    elif kern and "spill stores" in text:
        spill = int(re.search(r"(\\d+) bytes spill stores", text).group(1))
    elif kern and "Used" in text:
        print(f"  {kern}: {re.search(r'Used (\\d+) registers', text).group(1)} regs, {spill} B spilled")
        kern = None
"""


def parse(variant: str) -> dict:
    m = re.fullmatch(r"zc(\d+)-b(\d+)-h(\d+)(?:-d(\d+))?(-sync)?", variant)
    if m is None:
        raise SystemExit(f"bad variant {variant!r}: expected e.g. zc32-b4-h2, zc32-b4-h2-d0 or zc32-b4-h2-sync")
    defines = {"HPCCG_WS_ZC": int(m[1]), "HPCCG_WS_BLOCKS": int(m[2]), "HPCCG_WS_BLOCKS_BF16": int(m[3]),
               "HPCCG_WS_SYNC_ONLY": int(bool(m[5]))}
    if m[4] is not None:
        defines["HPCCG_WS_DIRECT"] = int(m[4])
    return defines


def main(argv) -> int:
    order = list(argv) or DEFAULTS
    dirs = {v: copy_with_defines(OUT / v, "wholesolve.cu", parse(v)) for v in dict.fromkeys(order)}
    build_and_time(dirs, order, TIMER)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
