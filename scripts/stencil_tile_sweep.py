"""Time the stencil kernels K1-K3 and K4s at several tile constants on the card.

    python3 scripts/stencil_tile_sweep.py [VARIANT ...]

A VARIANT sets the four constants of ``csrc/stencil.cu``, e.g.
``ty8-zc32-ns3-mb264`` (the build's defaults): TY warps (output rows) per
block, at most ZC z-planes per block, NS staged planes in K1/K2's cp.async
ring (K3's, which stages r and p, has one fewer, at least 2), and MB, the
blocks below which the z chunk is halved. Without arguments it sweeps each
constant around the defaults. Each variant is a copy of
``hpccg_tpu_torch/`` and ``chip_smoke.py`` under ``build/stencil_sweep/``
whose ``csrc/stencil.cu`` starts with the four ``#define HPCCG_STENCIL_*``
lines; the copies are built in parallel first. Then each variant runs in
its own process, in the order given and again in reverse, checks K3 against
its plain version (p' bit for bit, Ap' within 1e-5 of max|Ap'|) and K3
without its Ap' store and K4s against K3 and K4 (p', x' and r' bit for
bit), and prints the device time of one launch (CUDA-graph replays,
``chip_smoke._graph_ms``) of K1, K2, K3 and K4s (alpha 0, so that x and r
stay as they are), 27-point, in float32 at 100^3
and 256^3, in bfloat16 at 256^3 and in float64 at 100^3 (K2 is K7 there),
with the z chunk and the blocks of each grid. Runs on a CUDA card only.
"""

from __future__ import annotations

import re
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "stencil_sweep"
DEFAULTS = ["ty8-zc32-ns3-mb264", "ty4-zc32-ns3-mb264", "ty16-zc32-ns3-mb264", "ty8-zc16-ns3-mb264",
            "ty8-zc64-ns3-mb264", "ty8-zc32-ns2-mb264", "ty8-zc32-ns4-mb264", "ty8-zc32-ns3-mb132",
            "ty8-zc32-ns3-mb528"]

BUILD = """import sys
sys.path.insert(0, ".")
from hpccg_tpu_torch.ops.cuda import build
print(round(build.build(), 1))
"""

# run in each copy's own process, with the copy as the working directory
TIMER = """import sys, torch
sys.path.insert(0, ".")
import chip_smoke as cs
from hpccg_tpu_torch.config import Stencil
from hpccg_tpu_torch.operators import StencilOperator
from hpccg_tpu_torch.ops.cuda import fused_cg as fc
from hpccg_tpu_torch.ops.cuda import stencil as st
f32, f64, bf16 = torch.float32, torch.float64, torch.bfloat16
gen = torch.Generator(device="cuda").manual_seed(3)
line = []
for dims, dtype in (((100,) * 3, f32), ((256,) * 3, f32), ((256,) * 3, bf16), ((100,) * 3, f64)):
    op = StencilOperator(*dims, Stencil.S27, dtype)
    grid = dims[::-1]
    r, p, x = (torch.randn(grid, generator=gen, device="cuda").to(dtype) for _ in range(3))
    beta = torch.tensor([0.37], device="cuda", dtype=f64 if dtype == f64 else f32)
    pp, ap, _ = st.update_p_apply(op, r, p, beta)
    pp0, ap0, _ = st.update_p_apply_plain(op, r, p, beta)
    err = float((ap.double() - ap0.double()).abs().max() / ap0.double().abs().max())
    assert torch.equal(pp, pp0) and err <= (1e-5 if dtype != bf16 else 2.0 ** -8), (dims, dtype, err)
    pn = st.update_p_apply(op, r, p, beta, store_ap=False)[0]
    xs, rs, xk, rk = x.clone(), r.clone(), x.clone(), r.clone()
    st.update_x_r_stencil(op, xs, rs, pn, beta)
    fc.update_x_r(xk, rk, pp, ap, beta)
    assert torch.equal(pn, pp) and torch.equal(xs, xk) and torch.equal(rs, rk), (dims, dtype, "K4s")
    zero = torch.zeros_like(beta)
    out, out2 = torch.empty_like(r), torch.empty_like(r)
    parts = torch.empty((st.num_partials(op, "cuda"),), device="cuda", dtype=beta.dtype)
    fns = {"K1": lambda: st.spmv_stencil(op, r, out=out),
           "K2": lambda: st.spmv_stencil_pap(op, r, out=out, partials=parts),
           "K3": lambda: st.update_p_apply(op, r, p, beta, out_p=out, out_ap=out2, partials=parts),
           "K4s": lambda: st.update_x_r_stencil(op, xs, rs, p, zero, partials=parts)}
    geo = st.tile_geometry(*dims, dtype)
    line.append(f"{dims[0]}^3 {str(dtype)[6:]} (zc {geo.z_chunk}, {geo.blocks} blocks): "
                + " ".join(f"{k}={cs._graph_ms(fn) * 1e3:.2f}" for k, fn in fns.items()))
print("; ".join(line) + " us")
"""


def parse(variant: str) -> dict:
    m = re.fullmatch(r"ty(\d+)-zc(\d+)-ns(\d+)-mb(\d+)", variant)
    if m is None:
        raise SystemExit(f"bad variant {variant!r}: expected e.g. ty8-zc32-ns3-mb264")
    return dict(zip(("TY", "ZC", "NSTAGE", "MIN_BLOCKS"), map(int, m.groups())))


def copy_with_defines(dst: Path, source: str, defines: dict) -> Path:
    """A copy of the package and chip_smoke.py at dst whose
    ``csrc/<source>`` starts with a #define line for each item of
    ``defines``."""
    if dst.exists():
        shutil.rmtree(dst)
    shutil.copytree(ROOT / "hpccg_tpu_torch", dst / "hpccg_tpu_torch", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "chip_smoke.py", dst / "chip_smoke.py")
    src = dst / "hpccg_tpu_torch" / "csrc" / source
    src.write_text("".join(f"#define {k} {v}\n" for k, v in defines.items()) + src.read_text())
    return dst


def build_and_time(dirs: dict, order: list, timer: str, args=()) -> None:
    """Build every copy (three at a time), then run ``timer`` (with
    ``args`` as its arguments) in each, in the order given and again in
    reverse, printing what it prints."""
    def build(item):
        variant, cwd = item
        proc = subprocess.run([sys.executable, "-c", BUILD], cwd=cwd, capture_output=True, text=True, timeout=900)
        return variant, proc

    with ThreadPoolExecutor(max_workers=3) as pool:
        for variant, proc in pool.map(build, dirs.items()):
            print(f"--- build {variant} (rc {proc.returncode}): "
                  f"{proc.stdout.strip() or proc.stderr[-3000:]} s", flush=True)
    for variant in order + order[::-1]:
        proc = subprocess.run([sys.executable, "-c", timer, *args], cwd=dirs[variant], capture_output=True,
                              text=True, timeout=600)
        print(f"--- {variant} (rc {proc.returncode}): {proc.stdout.strip() or proc.stderr[-3000:]}", flush=True)


def main(argv) -> int:
    order = list(argv) or DEFAULTS
    dirs = {v: copy_with_defines(OUT / v, "stencil.cu", {f"HPCCG_STENCIL_{k}": n for k, n in parse(v).items()})
            for v in dict.fromkeys(order)}
    build_and_time(dirs, order, TIMER)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
