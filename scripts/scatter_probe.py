"""Probe random gathers on the card: how fast x[cols[k]] is served from
global memory, from one block's shared memory and through distributed
shared memory across a thread-block cluster, on the column patterns of the
wide-scatter classes.

    python3 scripts/scatter_probe.py

Builds ``scripts/scatter_probe.cu`` with nvcc into ``build/scatter_probe/``
and times its modes (the source's header says what each does) with CUDA
events over 20 launches, on two patterns in float32 and float64: K13's, the
slot-major columns of the randomly permuted 64^3 27-point stencil as
loaded (262,144 rows, 27 slots, x of 1 MiB in float32), and K14's, a
random wide scatter (n = 10^6, 9 slots within +-3*10^5). Shared memory
holds 128 KB a block (2^15 float32, 2^14 float64 elements); where x does
not fit (one block, or C blocks of a cluster), the columns are cut to the
part that does (``col & (C * W - 1)``), which keeps them random. Prints
µs per launch, G gathers/s (rows x slots / time), the resident clusters
(cudaOccupancyMaxActiveClusters) and the card's name and power limit.
Runs on a CUDA card only.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from hpccg_tpu_torch.ops.cuda.build import ARCH_FLAGS, nvcc_path  # noqa: E402

OUT = ROOT / "build" / "scatter_probe"
SMEM_BYTES = 1 << 17  # 128 KB of x a block
MODES = [("columns only, 2 blocks/SM", 0, 1, 2), ("global __ldg, 2 blocks/SM", 1, 1, 2),
         ("global __ldg, 1 block/SM", 1, 1, 1), ("global __ldg, columns evict-first, 1 block/SM", 5, 1, 1),
         ("one block's shared memory", 2, 1, 1)]
MODES += [(f"cluster of {c}, distributed shared memory", 3, c, 1) for c in (2, 4, 8, 16)]
MODES += [(f"cluster of {c}, staging and barriers only", 4, c, 1) for c in (8, 16)]


def build() -> ctypes.CDLL:
    OUT.mkdir(parents=True, exist_ok=True)
    lib = OUT / "libscatter_probe.so"
    cmd = [nvcc_path(), *ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-shared", "-o",
           str(lib), str(ROOT / "scripts" / "scatter_probe.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    (OUT / "nvcc.log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise SystemExit(f"nvcc failed:\n{proc.stderr[-3000:]}")
    dll = ctypes.CDLL(str(lib))
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    dll.scatter_probe.argtypes = [I, I, I, I, P, I, LL, P, I, I, P, I, P, P]
    dll.scatter_probe.restype = I
    return dll


def patterns():
    """(name, slot-major int32 columns on the card, len(x))."""
    perm, _ = cs._permuted(cs._stencil_ell((64, 64, 64), torch.float32, "cpu"), 1)
    gen = torch.Generator(device="cuda").manual_seed(2024)
    wide = cs._wide_scatter(1_000_000, 9, 300_000, torch.float32, gen)
    for name, A in (("K13 permuted 64^3", perm.A), ("K14 wide scatter n=10^6", wide)):
        yield name, A.cols.t().contiguous().to("cuda"), A.total_nrow


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()


def main() -> int:
    print(f"card: {card()}", flush=True)
    dll = build()
    for name, cols, nx in patterns():
        width, n = cols.shape
        for dtype in (torch.float32, torch.float64):
            s = torch.empty((), dtype=dtype).element_size()
            x = torch.randn(nx, device="cuda", dtype=dtype)
            y = torch.empty(n, device="cuda", dtype=dtype)
            wmax = (SMEM_BYTES // s).bit_length() - 1
            for label, mode, csize, bps in MODES:
                cshift = csize.bit_length() - 1
                wshift = min(wmax, (nx >> cshift).bit_length() - 1) if 2 <= mode <= 4 else 0
                ms, clusters = ctypes.c_float(), ctypes.c_int()
                err = dll.scatter_probe(s, mode, csize, bps, cols.data_ptr(), width, n, x.data_ptr(), wshift,
                                        cshift, y.data_ptr(), 20, ctypes.byref(ms), ctypes.byref(clusters))
                if err:
                    print(f"{name} {str(dtype)[6:]} {label}: CUDA error {err}", flush=True)
                    continue
                us = ms.value * 1e3
                cut = f", x cut to {csize << wshift} of {nx}" if mode in (2, 3) and (csize << wshift) < nx else ""
                extra = f", {clusters.value} clusters resident" if mode in (3, 4) else ""
                print(f"{name} {str(dtype)[6:]} {label}: {us:.2f} us, {width * n / us / 1e3:.1f} G gathers/s"
                      f"{cut}{extra}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
