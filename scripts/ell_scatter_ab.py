"""Time the wide-scatter ELL kernels of two checkouts in turns on the card,
with the other sparse kernels as controls, and compare their outputs.

    python3 scripts/ell_scatter_ab.py PARENT_DIR [CHANGE_DIR]

PARENT_DIR and CHANGE_DIR (default: this checkout) are checkouts of the
repo, for example the parent commit unpacked with ``git archive`` into a
gitignored directory. Both are built first, side by side. Then each
reading runs in its own process with the checkout as the working
directory, in the order parent, change, change, parent, and prints the
device time of one launch (CUDA-graph replays, ``chip_smoke._graph_ms``)
of the layout that each checkout's ``prepare_ell`` chooses, and the host
time ``prepare_ell`` takes to choose and build it: K13's class
(the randomly permuted 64^3 27-point stencil as loaded) and K14's (a random
wide scatter, n = 10^6, 9 slots within +-3*10^5) in float32 and float64;
the controls K11/K12 and K11's bf16 instance on generate_ell(128^3) and on
the permuted 64^3 after RCM, and K9/K10 on the 128^3 DIA; then slope-timed
µs per CG iteration (CUDA events, legs of 17 and 145 iterations) of the
permuted 128^3 float32 solve as loaded on ``auto`` and of K5 (megakernel)
at 100^3 float32. Each process saves every SpMV's output and K5's trace
and x under ``build/ell_scatter_ab/``; the script then says which are bit
for bit the same between the first parent's and the first change's run,
and between each checkout's two runs. Prints the card's name and power
limit. Runs on a CUDA card only.
"""

from __future__ import annotations

import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "ell_scatter_ab"

BUILD = """import sys
sys.path.insert(0, ".")
from hpccg_tpu_torch.ops.cuda import build
print(round(build.build(), 1))
"""

# run in each checkout's own process, with the checkout as the working
# directory; argv[1] is the file that receives the saved outputs
TIMER = """import sys, time, torch
sys.path.insert(0, ".")
import chip_smoke as cs
from hpccg_tpu_torch import ProblemConfig, generate_problem, make_cg
from hpccg_tpu_torch.ops.cuda import dia as cdia, ell as cell
from hpccg_tpu_torch.reorder import permute_ell, rcm_permutation
from hpccg_tpu_torch.utils.timing import time_loop_slope
out, saved, setup = {}, {}, {}
perm, _ = cs._permuted(cs._stencil_ell((64, 64, 64), torch.float64, "cpu"), 1)
rcm = permute_ell(perm.A, rcm_permutation(perm.A))
f32, f64, bf16 = torch.float32, torch.float64, torch.bfloat16


def spmv(tag, S, x, fn, dtype, n):
    o = torch.empty(n, device="cuda", dtype=dtype)
    out[tag] = cs._graph_ms(lambda: fn(S, x, out=o)) * 1e3
    saved[tag] = (fn(S, x).cpu(),)


for dtype in (f32, f64):
    gen = torch.Generator(device="cuda").manual_seed(2024)
    cases = [("K13 permuted 64^3", cs._cast(perm.A, dtype)),
             ("K14 wide scatter", cs._wide_scatter(1_000_000, 9, 300_000, dtype, gen)),
             ("K11/K12 128^3", cs._explicit_128(dtype)[0].A), ("K11/K12 RCM'd 64^3", cs._cast(rcm, dtype))]
    for tag, A in cases:
        x = torch.randn(A.local_nrow, generator=gen, device="cuda", dtype=dtype)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        S = cell.prepare_ell(A)
        torch.cuda.synchronize()
        setup[f"{tag} {str(dtype)[6:]}"] = f"{time.perf_counter() - t0:.3f} s ({type(S).__name__})"
        spmv(f"{tag} {str(dtype)[6:]}", S, x, cell.spmv_ell, dtype, A.local_nrow)
    D = cs._explicit_128(dtype)[1]
    x = torch.randn(D.local_nrow, generator=gen, device="cuda", dtype=dtype)
    spmv(f"K9/K10 128^3 {str(dtype)[6:]}", cdia.prepare_dia(D), x, cdia.spmv_dia, dtype, D.local_nrow)
    cs._explicit_128.cache_clear()
    torch.cuda.empty_cache()
gen = torch.Generator(device="cuda").manual_seed(7)
for tag, A in (("K11/bf16 128^3", cs._cast(cs._stencil_ell((128,) * 3, f32, "cpu").A, bf16)),
               ("K11/bf16 RCM'd 64^3", cs._cast(rcm, bf16))):
    x = torch.randn(A.local_nrow, generator=gen, device="cuda").to(bf16)
    spmv(tag, cell.prepare_ell(A), x, cell.spmv_ell, bf16, A.local_nrow)
twin, _ = cs._permuted(cs._stencil_ell((128,) * 3, f32, "cpu"), 7)
A, b, x0 = twin.A.to("cuda"), twin.b.cuda(), twin.x0.cuda()
t = time_loop_slope(lambda k: make_cg(A, max_iter=k + 1, tolerance=0.0)(b, x0), device="cuda", short=17, long=145)
out["permuted 128^3 f32 solve as loaded (us/iter)"] = t * 1e6
del A, b, x0, twin
g = generate_problem(ProblemConfig(100, 100, 100, dtype=f32), "cuda")
t = time_loop_slope(lambda k: make_cg(g.A, max_iter=k + 1, backend="megakernel")(g.b, g.x0), device="cuda",
                    short=17, long=145)
out["K5 100^3 f32 (us/iter)"] = t * 1e6
res = make_cg(g.A, max_iter=150, backend="megakernel")(g.b, g.x0)
saved["K5 100^3 f32"] = (res.trace.cpu(), res.x.cpu())
torch.save(saved, sys.argv[1])
print(", ".join(f"{k} {v:.2f}" for k, v in out.items()) + " us")
print("prepare_ell: " + ", ".join(f"{k} {v}" for k, v in setup.items()))
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

    def build(cwd):
        return subprocess.run([sys.executable, "-c", BUILD], cwd=cwd, capture_output=True, text=True, timeout=900)

    with ThreadPoolExecutor(max_workers=2) as pool:
        for tag, proc in zip(("parent", "change"), pool.map(build, (parent, change))):
            print(f"--- build {tag} (rc {proc.returncode}): {proc.stdout.strip() or proc.stderr[-3000:]} s", flush=True)
            if proc.returncode != 0:
                return 1
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
