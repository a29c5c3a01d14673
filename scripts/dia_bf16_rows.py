"""Time K9/bf16 with 1, 2, 4 or 8 rows per thread on the card.

    python3 scripts/dia_bf16_rows.py [4 1 2 8 8 2 1 4]

Each variant is a copy of ``hpccg_tpu_torch/`` and ``chip_smoke.py`` under
``build/dia_bf16_rows/r<R>/`` whose ``csrc/dia.cu`` starts with
``#define HPCCG_DIA_BF16_ROWS R``: its K9/bf16 reads the bf16 data of R rows
in one R * 2-byte load; R = 4 is the build's default. Each runs in its
own process (its own build) and prints the device time of one K9/bf16
launch (CUDA-graph replays, ``chip_smoke._graph_ms``) on the 128^3
stencil, on rank 1's extended vector of the 4 x 128^3/4 dia-halo tier (the
window instance), and of the float32 K9 on the same matrix, three readings
each, after checking both bf16 products bit for bit against the plain
version. Runs on a CUDA card only.
"""

from __future__ import annotations

import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "dia_bf16_rows"

# run in each copy's own process, with the copy as the working directory
TIMER = """import sys, torch
sys.path.insert(0, ".")
import chip_smoke as cs
from hpccg_tpu_torch.ops.cuda import build, dia as cdia
from hpccg_tpu_torch.parallel import cg as pcg
print("build s", round(build.build(), 1))
bf = torch.bfloat16
D32 = cs._explicit_128(torch.float32)[1]
D = cs._bf16_dia(D32)
P = cdia.prepare_dia(D)
x = torch.randn(D.local_nrow, generator=torch.Generator(device="cuda").manual_seed(7), device="cuda").to(bf)
out = torch.empty_like(x)
assert torch.equal(cdia.spmv_dia(P, x), cdia.spmv_dia_plain(P, x))
mesh = cs._one_card(4)
tier = pcg.HaloTier(pcg.shard_matrix(D, mesh), mesh.devices, "dia-halo")
(Pw, _), ext = tier.kernels[1], tier.strips.fill(mesh.shard(x))[1]
assert torch.equal(cdia.spmv_dia(Pw, ext), cdia.spmv_dia_plain(Pw, ext))
outw = torch.empty((Pw.A.local_nrow,), dtype=bf, device="cuda")
P32, x32 = cdia.prepare_dia(D32), x.float()
o32 = torch.empty_like(x32)
rows = [("K9/bf16 128^3", lambda: cdia.spmv_dia(P, x, out=out)),
        ("window rank 1 of 4 x 128^3/4", lambda: cdia.spmv_dia(Pw, ext, out=outw)),
        ("K9 f32 128^3", lambda: cdia.spmv_dia(P32, x32, out=o32))]
for what, fn in rows:
    print(what, "us", " ".join(f"{cs._graph_ms(fn) * 1e3:.2f}" for _ in range(3)))
"""


def make_variant(rows: int) -> Path:
    """A copy of the package whose K9/bf16 takes ``rows`` rows per thread."""
    dst = OUT / f"r{rows}"
    if dst.exists():
        shutil.rmtree(dst)
    shutil.copytree(ROOT / "hpccg_tpu_torch", dst / "hpccg_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "chip_smoke.py", dst / "chip_smoke.py")
    src = dst / "hpccg_tpu_torch" / "csrc" / "dia.cu"
    src.write_text(f"#define HPCCG_DIA_BF16_ROWS {rows}\n" + src.read_text())
    return dst


def main(argv) -> int:
    order = [int(a) for a in argv] or [4, 1, 2, 8, 8, 2, 1, 4]
    if any(r not in (1, 2, 4, 8) for r in order):
        raise SystemExit("rows per thread: 1, 2, 4 or 8")
    dirs = {r: make_variant(r) for r in sorted(set(order))}
    for rows in order:
        proc = subprocess.run([sys.executable, "-c", TIMER], cwd=dirs[rows], capture_output=True, text=True,
                              timeout=900)
        print(f"--- {rows} rows per thread (rc {proc.returncode})", flush=True)
        print(proc.stdout.strip() or proc.stderr[-3000:], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
