"""Time the wide-scatter ELL kernels at several build constants on the
card, and the builds that take the ELL kernel's gather apart.

    python3 scripts/ell_scatter_sweep.py [--bands B1,...] [--grids G1,...] [VARIANT ...]

A VARIANT is ``default`` (the build as it is) or a comma-separated list of
``NAME=VALUE`` items, each a ``#define HPCCG_<NAME> <VALUE>`` line at the
top of ``csrc/ell.cu`` and of ``csrc/ell_scatter.cu`` where that file
exists: ``ELL_SPLIT=1`` builds the ELL kernel K11/K12 with its gather read
from x[row] (every byte stream unchanged, the gather local),
``ELL_SPLIT=2`` with the column stream and the gather and no value stream.
(The levers measured, the slots in flight, the streams' cache hint, the
dependent launch and the threads a block, are plain constants at their
winners in ``csrc/ell.cu`` and ``csrc/ell_scatter.cu``: a variant that
tries one again edits those files.)
Each variant is a copy of ``hpccg_tpu_torch/`` and ``chip_smoke.py`` under
``build/ell_scatter_sweep/``; the copies are built three at a time first.
Then each variant runs in its own process, in the order given and again in
reverse, and prints the device time of one launch (CUDA-graph replays,
``chip_smoke._graph_ms``) of K11/K12 on the slot-major layout and of K13's
relabelled kernel (rows in reverse Cuthill-McKee order) on K13's class (the
randomly permuted 64^3 27-point stencil as loaded), on the same matrix
after RCM and on K14's class (a random wide scatter, n = 10^6, 9 slots
within +-3*10^5), in float32 and float64, the relabelled kernel checked
bit for bit against K11/K12 and against a second launch; with ``--bands
B1,B2,...`` also on wide scatters of half-width B and with ``--grids
G1,...`` on randomly permuted G^3 stencils (the sweeps that place the
relabel rule's thresholds), with each matrix's median group span
(``reorder.group_span``), its search depth (``reorder.bfs_depth``) and the
chooser's pick. Runs on a CUDA card only.
"""

from __future__ import annotations

import re
import subprocess
import sys

from stencil_tile_sweep import ROOT, build_and_time, copy_with_defines

OUT = ROOT / "build" / "ell_scatter_sweep"
DEFAULTS = ["default", "ELL_SPLIT=1", "ELL_SPLIT=2"]

# run in each copy's own process, with the copy as the working directory
TIMER = """import sys, time, torch
sys.path.insert(0, ".")
import chip_smoke as cs
from hpccg_tpu_torch.ops.cuda import ell as cell
from hpccg_tpu_torch import reorder
perm, _ = cs._permuted(cs._stencil_ell((64, 64, 64), torch.float64, "cpu"), 1)
t0 = time.perf_counter()
rcm = reorder.permute_ell(perm.A, reorder.rcm_permutation(perm.A))
print(f"RCM of the permuted 64^3 on the host: {time.perf_counter() - t0:.2f} s")
bands = [int(a[2:]) for a in sys.argv[1:] if a.startswith("b:")]
grids = [int(a[2:]) for a in sys.argv[1:] if a.startswith("g:")]
for dtype in (torch.float32, torch.float64):
    gen = torch.Generator(device="cuda").manual_seed(2024)
    cases = [("K13 permuted 64^3", cs._cast(perm.A, dtype)), ("permuted 64^3 after RCM", cs._cast(rcm, dtype)),
             ("K14 wide scatter bw 3e5", cs._wide_scatter(1_000_000, 9, 300_000, dtype, gen))]
    cases += [(f"wide scatter bw {b}", cs._wide_scatter(1_000_000, 9, b, dtype, gen)) for b in bands]
    cases += [(f"permuted {g}^3", cs._cast(cs._permuted(cs._stencil_ell((g,) * 3, dtype, "cpu"), 1)[0].A, dtype))
              for g in grids]
    for tag, A in cases:
        x = torch.randn(A.local_nrow, device="cuda", dtype=dtype)
        out = torch.empty_like(x)
        E = cell.ell_slots(A)
        want = cell.spmv_ell(E, x)
        line = f"{tag} {str(dtype)[6:]}: K11/K12 {cs._graph_ms(lambda: cell.spmv_ell(E, x, out=out)) * 1e3:.2f}"
        t0 = time.perf_counter()
        S = cell.prepare_scatter(A, reorder.rcm_permutation(A))
        line += f", relabelled (prepare {time.perf_counter() - t0:.2f} s)"
        got, again = cell.spmv_ell(S, x), cell.spmv_ell(S, x)
        same = torch.equal(got, want) and torch.equal(got, again)
        line += f" {cs._graph_ms(lambda: cell.spmv_ell(S, x, out=out)) * 1e3:.2f}" + ("" if same else " DIFFERS")
        span = reorder.group_span(A.cols, A.valid, A.vals.element_size())
        line += (f"; span {span / 1e3:.0f} kB, depth {reorder.bfs_depth(A)}, "
                 f"chooser {type(cell.prepare_ell(A)).__name__}")
        print(line + " us", flush=True)
"""


def parse(variant: str) -> dict:
    if variant == "default":
        return {}
    defines = {}
    for item in variant.split(","):
        m = re.fullmatch(r"([A-Z][A-Z0-9_]*)=(-?\d+)", item)
        if m is None:
            raise SystemExit(f"bad variant {variant!r}: expected default or NAME=VALUE[,NAME=VALUE...]")
        defines[f"HPCCG_{m[1]}"] = int(m[2])
    return defines


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()


def main(argv) -> int:
    argv = list(argv)
    extra = []
    while argv[:1] in (["--bands"], ["--grids"]):
        extra += [f"{argv[0][2]}:{v}" for v in argv[1].split(",")]
        argv = argv[2:]
    order = argv or DEFAULTS
    print(f"card: {card()}", flush=True)
    dirs = {}
    for v in dict.fromkeys(order):
        defines = parse(v)
        dst = copy_with_defines(OUT / re.sub(r"[^A-Za-z0-9]+", "-", v), "ell.cu", defines)
        other = dst / "hpccg_tpu_torch" / "csrc" / "ell_scatter.cu"
        if other.exists():
            other.write_text("".join(f"#define {k} {n}\n" for k, n in defines.items()) + other.read_text())
        dirs[v] = dst
    build_and_time(dirs, order, TIMER, extra)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
