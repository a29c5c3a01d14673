"""Time the column-window form of the ELL SpMV against the ELL kernel on
K14's class, a random wide scatter (n = 10^6, 9 slots within +-3*10^5).

    python3 scripts/ell_window.py

The window form (``scripts/ell_window.cu``, whose header says how it
works) buckets each row's slots by column window, stages one window of x a
block in shared memory and sums each row's partials in window order in a
second kernel, with no atomics: the per-SM-window counterpart of the JAX
package's strip and window tiers. This script builds that source with nvcc
into ``build/ell_window/``, builds the bucketed layout on the card with
torch, checks each form against a float64 sum of the same matrix (within
1e-5 / 1e-13 of max|y| in float32 / float64) and against its own second
launch (bit for bit), and prints the device time of one launch (CUDA-graph
replays, ``chip_smoke._graph_ms``) of: the ELL kernel on its slot-major
layout (K11/K12, ``ops/cuda/ell.py``); the window form at windows of 96 KB
(512 threads, two blocks a SM) and 192 KB (1024 threads, one block a SM),
with one and two chunks of a window's segments per SM, each with its
partials stored in row order (scattered stores, contiguous reads) and
coalesced (contiguous stores, scattered reads); and, for the best of
those, its window kernel and its combine kernel alone. Also prints the
layout's segments, padded entries and the bytes each form moves, and the
card's name and power limit. Runs on a CUDA card only.
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
from hpccg_tpu_torch.ops.cuda import ell as cell  # noqa: E402
from hpccg_tpu_torch.ops.cuda.build import NVCC_FLAGS, nvcc_path  # noqa: E402

OUT = ROOT / "build" / "ell_window"
RTOL = {torch.float32: 1e-5, torch.float64: 1e-13}
# (window bytes, threads a block)
SHAPES = [(96 << 10, 512), (192 << 10, 1024)]


def build() -> ctypes.CDLL:
    OUT.mkdir(parents=True, exist_ok=True)
    lib = OUT / "libell_window.so"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-shared", "-o", str(lib), str(ROOT / "scripts" / "ell_window.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    (OUT / "nvcc.log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise SystemExit(f"nvcc failed:\n{proc.stderr[-3000:]}")
    dll = ctypes.CDLL(str(lib))
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for name in ("ell_window_f32", "ell_window_f64"):
        fn = getattr(dll, name)
        fn.argtypes = [P, P, P, P, P, I, P, P, P, P, LL, I, I, P, P, I, P]
        fn.restype = I
    return dll


def layout(A, W: int, chunks: int, nsm: int) -> dict:
    """The bucketed layout of EllMatrix A (on the card) for windows of W
    elements and ``chunks`` chunks a SM."""
    dev = A.cols.device
    n, width = A.cols.shape
    ri, si = A.valid.nonzero(as_tuple=True)
    ci = A.cols[ri, si].long()
    vi = A.vals[ri, si]
    wi = ci // W
    nwin = (n + W - 1) // W
    order = torch.argsort((wi * n + ri) * width + si)
    ri, ci, vi, wi = ri[order], ci[order], vi[order], wi[order]
    E = ri.numel()
    seg_key = wi * n + ri
    first = torch.ones(E, dtype=torch.bool, device=dev)
    first[1:] = seg_key[1:] != seg_key[:-1]
    segid = torch.cumsum(first.long(), 0) - 1
    seg_start = first.nonzero().squeeze(1)
    nseg = seg_start.numel()
    seg_len = torch.diff(torch.cat([seg_start, torch.tensor([E], device=dev)]))
    seg_w, seg_r = wi[seg_start], ri[seg_start]
    # ppos: a segment's rank in (row, window) order is rowptr[row] + its rank among the row's windows
    ppos = torch.empty(nseg, dtype=torch.long, device=dev)
    ppos[torch.argsort(seg_r * nwin + seg_w)] = torch.arange(nseg, device=dev)
    rowptr = torch.zeros(n + 1, dtype=torch.long, device=dev)
    rowptr[1:] = torch.cumsum(torch.bincount(seg_r, minlength=n), 0)
    # segments within a window, longest first, padded to groups of 32
    L = int(seg_len.max())
    o3 = torch.argsort((seg_w * (L + 1) + (L - seg_len)) * n + seg_r)
    win_count = torch.bincount(seg_w, minlength=nwin)
    win_pad = (win_count + 31) // 32 * 32
    pad_base = torch.cumsum(win_pad, 0) - win_pad
    win_start = torch.cumsum(win_count, 0) - win_count
    w_sorted = seg_w[o3]
    pos = pad_base[w_sorted] + torch.arange(nseg, device=dev) - win_start[w_sorted]
    total = int(win_pad.sum())
    lens_p = torch.zeros(total, dtype=torch.long, device=dev)
    lens_p[pos] = seg_len[o3]
    ppos_p = torch.full((total,), nseg, dtype=torch.long, device=dev)
    ppos_p[pos] = ppos[o3]
    gw = lens_p.view(-1, 32).amax(dim=1)
    gofs = torch.zeros(gw.numel() + 1, dtype=torch.long, device=dev)
    gofs[1:] = torch.cumsum(gw * 32, 0)
    q_of_seg = torch.empty(nseg, dtype=torch.long, device=dev)
    q_of_seg[o3] = pos
    qpos = torch.empty(nseg, dtype=torch.long, device=dev)
    qpos[ppos] = q_of_seg
    q = q_of_seg[segid]
    t = torch.arange(E, device=dev) - seg_start[segid]
    dst = gofs[q // 32] + t * 32 + q % 32
    padded = int(gofs[-1])
    vals = torch.zeros(padded, dtype=A.dtype, device=dev)
    vals[dst] = vi
    lc = torch.zeros(padded, dtype=torch.int32, device=dev)
    lc[dst] = (ci - wi * W).to(torch.int32)
    lcol = torch.where(lc >= 1 << 15, lc - (1 << 16), lc).to(torch.int16)  # the bits of a uint16
    # chunks: each window's groups split evenly, about `chunks` a SM in all
    groups = (win_pad // 32).tolist()
    target = max(1, -(-sum(groups) // (chunks * nsm)))
    chunk_win, chunk_g, g0 = [], [0], 0
    for w, gcount in enumerate(groups):
        k = max(1, -(-gcount // target)) if gcount else 0
        for j in range(k):
            chunk_win.append(w)
            chunk_g.append(g0 + gcount * (j + 1) // k)
        g0 += gcount
    i32 = dict(dtype=torch.int32, device=dev)
    return dict(vals=vals, lcol=lcol, gofs=gofs, chunk_win=torch.tensor(chunk_win, **i32),
                chunk_g=torch.tensor(chunk_g, **i32), nchunks=len(chunk_win), ppos=ppos_p.to(torch.int32),
                qpos=qpos.to(torch.int32), rowptr=rowptr.to(torch.int32),
                part=torch.empty(max(nseg + 1, total), dtype=A.dtype, device=dev), W=W, n=n, nseg=nseg,
                padded=padded, entries=E)


def launch(dll, lay, x, y, threads, coalesced, which=3) -> None:
    fn = dll.ell_window_f32 if x.dtype == torch.float32 else dll.ell_window_f64
    err = fn(lay["vals"].data_ptr(), lay["lcol"].data_ptr(), lay["gofs"].data_ptr(), lay["chunk_win"].data_ptr(),
             lay["chunk_g"].data_ptr(), lay["nchunks"], lay["ppos"].data_ptr(),
             lay["qpos"].data_ptr() if coalesced else None, lay["rowptr"].data_ptr(),
             x.data_ptr(), lay["n"], lay["W"], threads, lay["part"].data_ptr(), y.data_ptr(), which,
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"ell_window: CUDA error {err}")


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()


def main() -> int:
    print(f"card: {card()}", flush=True)
    dll = build()
    nsm = torch.cuda.get_device_properties(0).multi_processor_count
    for dtype in (torch.float32, torch.float64):
        gen = torch.Generator(device="cuda").manual_seed(2024)
        A = cs._wide_scatter(1_000_000, 9, 300_000, dtype, gen)
        n, s = A.local_nrow, A.vals.element_size()
        x = torch.randn(n, generator=gen, device="cuda", dtype=dtype)
        want = (A.vals.double() * x.double()[A.cols.long()]).sum(dim=1)
        scale = float(want.abs().max())
        E = cell.ell_slots(A)
        out = torch.empty_like(x)
        k11 = cs._graph_ms(lambda: cell.spmv_ell(E, x, out=out)) * 1e3
        ell_mb = (A.width * n * (s + 4) + 2 * n * s) / 1e6
        tag = str(dtype)[6:]
        print(f"K14 wide scatter {tag}: ELL kernel (K11/K12) {k11:.2f} us, {ell_mb:.1f} MB", flush=True)
        best = None
        for wbytes, threads in SHAPES:
            for chunks in (1, 2):
                lay = layout(A, wbytes // s, chunks, nsm)
                for coalesced in (False, True):
                    y, again = torch.empty_like(x), torch.empty_like(x)
                    launch(dll, lay, x, y, threads, coalesced)
                    launch(dll, lay, x, again, threads, coalesced)
                    torch.cuda.synchronize()
                    err = float((y.double() - want).abs().max()) / scale
                    ok = err <= RTOL[dtype] and torch.equal(y, again)
                    us = cs._graph_ms(lambda: launch(dll, lay, x, out, threads, coalesced)) * 1e3
                    mb = (lay["padded"] * (s + 2) + (lay["padded"] // 32 + 1) * 8 + lay["ppos"].numel() * 4
                          + 2 * lay["nseg"] * s + (n + 1) * 4 + 2 * n * s) / 1e6
                    if coalesced:  # qpos instead of ppos
                        mb += (lay["nseg"] - lay["ppos"].numel()) * 4 / 1e6
                    print(f"K14 wide scatter {tag}: window form, {wbytes >> 10} KB windows, {threads} threads, "
                          f"{chunks} chunk(s)/SM ({lay['nchunks']} blocks), partials "
                          f"{'coalesced' if coalesced else 'in row order'}: {us:.2f} us, {mb:.1f} MB; "
                          f"{lay['nseg']} segments, {lay['padded']} padded entries of {lay['entries']}; "
                          f"err {err:.1e}{'' if ok else ' FAILED'}", flush=True)
                    if not ok:
                        return 1
                    if best is None or us < best[0]:
                        best = (us, lay, threads, wbytes, chunks, coalesced)
        us, lay, threads, wbytes, chunks, coalesced = best
        win = cs._graph_ms(lambda: launch(dll, lay, x, out, threads, coalesced, 1)) * 1e3
        comb = cs._graph_ms(lambda: launch(dll, lay, x, out, threads, coalesced, 2)) * 1e3
        print(f"K14 wide scatter {tag}: best window form ({wbytes >> 10} KB, {chunks} chunk(s)/SM, partials "
              f"{'coalesced' if coalesced else 'in row order'}) {us:.2f} us = window kernel {win:.2f} + combine "
              f"{comb:.2f}; ELL kernel {k11:.2f} us", flush=True)
        del lay, best
    return 0


if __name__ == "__main__":
    sys.exit(main())
