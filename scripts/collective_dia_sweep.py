"""Time the collective DIA whole solve K17 at several build constants on the
card, and the builds that take its vector work apart.

    python3 scripts/collective_dia_sweep.py [VARIANT ...]

A VARIANT is ``default`` (the build as it is) or a comma-separated list of
``NAME=VALUE`` items, each a ``#define HPCCG_DIA_<NAME> <VALUE>`` line at
the top of ``csrc/collective_dia.cu``: ``SYNC_ONLY=1`` builds K17 with no
vector work in its passes and its apply (the protocol alone: the rank
barriers, the exchanges and the allreduces), ``APPLY_ONLY=1`` with the
apply's work and no pass's; ``BLOCKS``, ``BLOCKS_CG1`` and ``BLOCKS_F64``
are the blocks per SM of float cg, float cg1 and double (the launch
bound). Each variant is a copy of
``hpccg_tpu_torch/`` and ``chip_smoke.py`` under
``build/collective_dia_sweep/``; the copies are built three at a time
first. Then each variant runs in its own process, in the order given and
again in reverse, and prints slope-timed µs per CG iteration (CUDA events,
legs of 17 and 145 iterations) of K17 cg and cg1 in float32 and cg in
float64 on the 128^3 27-point DIA matrix on 4 ranks of one card (the
distributed file mode's main path), with each launch's blocks per rank,
and the registers and spills of each instance. A variant that does its
vector work first holds cg and cg1 against the plain version on a
symmetric band of 4 x 2048 rows (niters and the trace, 20 iterations), in
both dtypes. Runs on a CUDA card only.
"""

from __future__ import annotations

import re
import subprocess
import sys

from stencil_tile_sweep import ROOT, build_and_time, copy_with_defines

OUT = ROOT / "build" / "collective_dia_sweep"
DEFAULTS = ["default", "SYNC_ONLY=1", "APPLY_ONLY=1"]

# run in each copy's own process, with the copy as the working directory
TIMER = """import re, sys, torch
sys.path.insert(0, ".")
import chip_smoke as cs
from hpccg_tpu_torch.ops.cuda import collective as col
from hpccg_tpu_torch.utils.timing import time_loop_slope
src = open("hpccg_tpu_torch/csrc/collective_dia.cu").read()
fixed = re.search(r"HPCCG_DIA_(SYNC|APPLY)_ONLY 1", src) is not None
f32, f64 = torch.float32, torch.float64
mesh = cs._one_card(4)
if not fixed:
    gen = torch.Generator(device="cuda").manual_seed(5)
    for dtype, rtol in ((f32, 1e-4), (f64, 1e-10)):
        prob = cs._sharded_file_problem(cs._sym_dia(4 * 2048, (1, 37, 200), dtype, gen), mesh)
        for method in ("cg", "cg1"):
            got = col.cg_collective_dia(prob.A, prob.b, prob.x0, method=method, max_iter=20)
            want = col.solve_plain_dia(prob.A, prob.b, prob.x0, method=method, max_iter=20)
            n = int(want.niters) + 1
            rel = float(((got.trace[:n] - want.trace[:n]).abs() / want.trace[:n]).max())
            assert int(got.niters) == int(want.niters) and rel <= rtol, (method, dtype, rel)
line = []
for dtype, methods in ((f32, ("cg", "cg1")), (f64, ("cg",))):
    prob, dia = cs._explicit_128(dtype)
    sp = cs._sharded_file_problem(dia, mesh, prob.b)
    L = sp.A[0].local_nrow
    for method in methods:
        t = time_loop_slope(lambda k: col.cg_collective_dia(sp.A, sp.b, sp.x0, method=method, max_iter=k + 1),
                            device="cuda", short=17, long=145)
        bpr = col.dia_blocks_per_rank(L, 4, dtype, method)
        line.append(f"{str(dtype)[6:]} {method} {t * 1e6:.2f} ({bpr} blocks/rank)")
    del prob, dia, sp
    cs._explicit_128.cache_clear()
    torch.cuda.empty_cache()
print(("split build: " if fixed else "") + "4 x 128^3/4: " + ", ".join(line) + " us/iter")
# registers and spill stores of each instance (ptxas -v)
kern = None
for text in open("build/hpccg_tpu_torch/nvcc.log").read().splitlines():
    m = re.search(r"Compiling entry function '(_Z\\w*collective_dia_kernel\\w*)'", text)
    if m:
        kern = m[1]
    elif kern and "spill stores" in text:
        spill = int(re.search(r"(\\d+) bytes spill stores", text).group(1))
    elif kern and "Used" in text:
        print(f"  {kern}: {re.search(r'Used (\\d+) registers', text).group(1)} regs, {spill} B spilled")
        kern = None
"""


def parse(variant: str) -> dict:
    if variant == "default":
        return {}
    defines = {}
    for item in variant.split(","):
        m = re.fullmatch(r"([A-Z][A-Z0-9_]*)=(-?\d+)", item)
        if m is None:
            raise SystemExit(f"bad variant {variant!r}: expected default or NAME=VALUE[,NAME=VALUE...]")
        defines[f"HPCCG_DIA_{m[1]}"] = int(m[2])
    return defines


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()


def main(argv) -> int:
    order = list(argv) or DEFAULTS
    print(f"card: {card()}", flush=True)
    dirs = {v: copy_with_defines(OUT / re.sub(r"[^A-Za-z0-9]+", "-", v), "collective_dia.cu", parse(v))
            for v in dict.fromkeys(order)}
    build_and_time(dirs, order, TIMER)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
