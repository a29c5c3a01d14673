#!/usr/bin/env python3
"""Smoke check of the PyTorch/CUDA port (hpccg_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and exits non-zero:

1. device: needs torch.cuda; prints the card's name and power limit
   (nvidia-smi), the torch/CUDA versions and nvcc's version;
2. build: compiles the kernel library from hpccg_tpu_torch/csrc with nvcc
   (one process per source, in parallel);
3. kernel vs plain: K1 (with and without halos), K2, K3, K4, the finalize
   step and K7 (float64) against their plain torch versions on the card, at
   33x17x9, 100^3 and 64x48x130, 27- and 7-point, float32 and float64; the
   whole-solve kernels K5 and K6 against theirs at the same shapes, at
   200x170x150 and 300x301x250 (more work items than blocks), on grids at
   the edges of their tile and with b and x0 views at odd element offsets,
   in float32, float64 and bfloat16 (max_iter 30): niters, trace, x, and
   two kernel solves bit-identical; then K1 and K4 past 2^31 points (64-bit
   offsets); then
   the DIA kernels K9/K10, the ELL gather kernels K11/K12 and the
   relabelled wide-scatter kernel K13 against theirs, float32 and float64,
   on the stencil at 100^3 and 128^3, a 1000-diagonal band, the permuted
   64^3 stencil as loaded (K13's class) and after RCM, a random wide
   scatter (K14's class, which K11/K12 take) and a skewed matrix, the
   chooser's pick checked on each, K13 bit for bit against K11/K12's launch
   on the same matrix (phase_sparse_kernels); then the collective whole solves K15 (cg,
   cg1) and K16 (pipecg) against theirs with 1, 2, 4, 6 and 8 ranks on the
   one card, per rank 33x17x9 (27/7-point), 64x48x13, 128x64x16 and
   64x400x9 (more work items than a rank's blocks at 8 ranks), float32
   and float64, then on grids at the edges of their staged tile (nx below
   a thread's 16 bytes, nx = 100, one below and one above the tile's width,
   ny not a multiple of its height, nz one below and one above the chosen
   z chunk) at 1, 2, 4 and 8 ranks and on b/x0 shards that are views at odd
   element offsets, each line with the grid and the access widths the
   launches ran at (phase_collective_kernels; bfloat16 in
   phase_collective_bf16_kernels); then, on a machine of two or more
   cards, K15/K16 across every card on their main path, one 64^3 rank a
   card, against the plain version and the one-card launch
   (phase_collective_across_cards); then K17 (cg, cg1) against its plain
   version with 1, 2, 4, 6 and 8 ranks on the card, float32 and float64,
   on symmetric bands: scattered within +-200 at 2048 and 100000 rows per
   rank, the diagonal alone, a band as wide as the shard, then at the edges
   of its tile (one row below, at and above it; rows per rank not a
   multiple of a thread's 16 bytes; b/x0 views at odd offsets; 1101
   diagonals, past the offsets kept in shared memory), and its apply bit
   for bit against DiaRows.matvec in every case and on the main path's
   128^3 matrix (phase_collective_dia_kernels); then K1-K4's bf16 instances against
   theirs at the same shapes and at 256^3, 27- and 7-point, with and
   without halo planes (vectors within 4 bf16 ulps of max|y|, partials
   1e-3, p', x', r' bit for bit, repeats bit-identical;
   phase_bf16_kernels); then the copy and write probe kernels against
   theirs and against the library calls, bit for bit, at 1 GiB per array
   (phase_probes); then K3 and K4 (and K1, K2, K7 on the same grids) against
   theirs in float32, float64 and bfloat16, 27- and 7-point, with and
   without halo planes, on grids at the edges of the stencil kernels' tile
   (nx below a thread's 16 bytes, nx = 100, one below and one above the
   tile's width, ny not a multiple of its height, nz below and one above
   the z chunk) and on views at odd element offsets (p', x', r' bit for bit,
   repeats bit-identical), and K3/K4 float32 at 256^3 (phase_tile_edges);
   then K5 and K6 at 256^3 float32 and bfloat16 against theirs, 50
   iterations (phase_whole_solve_256); then K3 without its Ap' store and
   K4s (the stencil update that recomputes Ap') against K3 with Ap' and K4
   (p', x', r' and K3's partials bit for bit) and against their plain
   versions, at the shapes above in float32, float64 and bfloat16, 27- and
   7-point, and on views at odd element offsets, and both timed at 300^3
   float64 beside K3 and K4 (phase_stencil_update);
4. main paths, each with every count set to 0 just before it and
   read just after: (a) slice 1, make_cg on the generated 27-point float32
   problem at 100^3 (max_iter 150) on auto (= pallas_fused: K3 without its
   Ap' store and K4s, no K4), pallas and stencil, then at 256^3 (max_iter
   50); (b) slice 2, megakernel and
   streamkernel at 100^3 and 256^3 float32 against stencil, at 256^3
   float32 and bfloat16 against their plain versions (trace and x), at 256^3
   bfloat16 against the float32 stencil trace, megakernel bfloat16 at 100^3
   for 300 iterations (niters 299: exact past bf16's 256), pallas_dd at
   100^3 float64 and pallas_v1 at 100^3 float32 against stencil; one
   whole-solve launch per solve; (c) slice 3, make_cg on generate_ell's
   128^3 matrix (2,097,152 rows, 55,742,968 nonzeros) as ELL and as DIA,
   float64 and float32, on auto (K9-K12), each against the stencil backend
   on the same grid (trace and x, max_iter 50); (d) the wide-scatter solves
   that K13's launches are counted on: the randomly permuted 128^3
   stencil through auto_structure (ell+rcm, float32) and as loaded
   (float32 and float64, K13's relabelled kernel), x in its order against
   the stencil solve's, with each solve's us per iteration (a CUDA-event
   window); and those that K14's are counted on: the same twin as loaded on
   the ell-allgather tier at 4 ranks of the card (each rank's scattered
   rows on K11/K12, gathered in place), float32 and float64; (e) slice 4, make_distributed_cg
   in float32 with every rank on the card, max_iter 150: 1 x 100^3, 64^3
   per rank on 1, 2, 4 and 8 ranks (weak scaling) and 64x64x1024 on 8
   ranks (strong scaling), each on collective (cg, cg1, pipecg: one launch
   of K15/K16 per solve), pallas_fused and stencil, against the
   single-device stencil solve of the same global grid (K3's and K4's
   launches are counted here: the distributed pallas_fused keeps K3 with
   Ap' and K4);
   (f) slice 5,
   distributed file mode: generate_ell(128^3) as DIA and as ELL, padded
   and sharded over 4 ranks of the card, float32 and float64, 50
   iterations, on dia-collective (K17 cg and cg1, one launch per solve,
   also against its plain version), dia-halo (K9/K10), ell-halo and
   ell-allgather (K11/K12), against the single-device DIA solve; and the
   permuted 64^3 f64 file after RCM on ell-halo; (g) slice 6, bf16 on
   K1-K4 and the benchmark: make_cg at 256^3 bf16 (max_iter 50) on pallas
   and pallas_fused (one K3 and one K4s launch per iteration) against the
   bf16 streamkernel trace, make_distributed_cg in bf16 on auto (= pallas,
   K2 with bf16 halo planes) on 4 ranks of 64^3 against the single-device
   pallas solve, and on pallas_fused (K3/K4 bf16 with the Ap' store: their
   rows' main path, driven alone) against the single-device pallas_fused
   solve, and ``hpccg_tpu_torch.bench --preset strong256
   --dtype bfloat16 --backend pallas_fused`` in process (K1/K3/K4s bf16 and
   both probes); (h) slice 8, make_cg at 256^3 float32 on auto (=
   pallas_fused, 49 launches each of K3 and K4s) against the stencil
   trace, twice, bit-identical, and make_distributed_cg on pallas_fused
   over 2 ranks of 256x256x128 (K3 with Ap' and K4, the 256^3 K3 and K4
   rows' main path, driven alone); (i) slice 9, make_cg at 256^3 on megakernel and
   streamkernel (one launch per solve), float32 against the stencil
   trace and both dtypes against their plain versions; (j) slice 10,
   make_distributed_cg on collective (cg, cg1, pipecg) at 4 x 100^3
   float32, past the L2, held as (e) holds its cells; (k) slice 16,
   make_cg at 300^3 float64 on auto (= pallas_fused: 49 launches each of
   K3 without its Ap' store and K4s, none of K4) against the K3 + K4 route
   of the same solve (solved outside the path's drive) and the stencil
   trace;
5. golden: the reference's 10^3 float64 run on pallas_fused, megakernel,
   streamkernel and pallas_dd, from an HPC-row file through the CLI (DIA)
   and through make_cg on the EllMatrix (ELL), as two 10x10x5 ranks on
   collective (K15, cg), and from the file as two ranks on dia-collective
   (K17, cg);
6. CLI: ``python -m hpccg_tpu_torch 100 100 100 --json`` with
   ``--dtype float32``, ``--backend megakernel --dtype float32`` and
   ``--dtype bfloat16`` (auto = streamkernel); ``--method cg1``, ``--method
   pipecg --rr-every 50`` (float32) and ``--refine 3`` (float64); file mode
   on a 64^3 float64 file (dia) and its randomly permuted twin (ell+rcm;
   ell with ``--no-reorder``), written by the port's writer, 149 iterations
   each; FILE --mesh 2 where the machine has two cards (one per rank; on
   one card it prints that it did not run); the benchmark, ``python -m
   hpccg_tpu_torch.bench --preset headline100`` and ``--preset strong256``
   as subprocesses: one JSON line each with the keys, niters 149, a finite
   value (phase_bench);
7. timing: slope-timed us per CG iteration for each backend at 100^3 and
   256^3 float32 and the whole-solve, pallas and pallas_fused backends at
   256^3 bfloat16 (CUDA
   events, legs of 65 and 1025 iterations), the whole-solve kernels' device
   busy share at 100^3 and 256^3 (float32 and bfloat16) and pallas_fused's
   at 256^3 float32 and bfloat16,
   and K1 against the plain matvec; at 128^3 float32
   and float64 the explicit solves (DIA, ELL, the ELL's plain version, the
   permuted matrix as loaded and after RCM; legs of 17 and 145) and
   K9-K12 per launch with effective GB/s; the collective backends at 1 x
   100^3 (beside megakernel), 4 x 100^3 and 8 x 64^3 (beside distributed
   pallas_fused; legs of 17 and 97; N ranks share one card, so these are no
   scaling numbers) and K15/K16 against their plain versions at 1 x 100^3
   and 4 x 100^3; at 4 x
   128^3/4 float32 DIA (legs of 17 and 145) K17 cg and cg1, dia-halo, the
   single-device DIA solve, K17 against its plain version (float32 and
   float64) and the busy share of one 50-iteration K17 solve. Nothing is
   asserted on times.

The kernels' JSON line gives, for every kernel: its launches on its main
path, max|kernel - plain|, its device ms and its plain version's (per
launch; per CG iteration for K5, K6, K15, K16 and K17), the bound (the larger of
the bytes it must move over 3.35 TB/s and its operations over the peak
rate) and, where one PyTorch call computes the same function, that call's
ms (conv3d for K1 and its bf16 instance, a sparse CSR product for K9-K14,
torch.add and torch.mul for the probes; null elsewhere). The bf16 rows
(K1/bf16-K4/bf16) are timed at 256^3, the probes at 1 GiB per array; K3
and K4 float32 have a second row at 256^3, past the L2, K5 and K6 a
second and a third, at 256^3 in float32 and bfloat16, and K15 and K16 a
second, at 4 x 100^3 in float32; K17 has a second, its float64 instance
(launches counted on slice 5's main path); K13 and K14 each a float64
row (slice 12); K3 without its Ap' store and K4s have rows at 300^3
float64, the benchmark's ref300 grid (slice 16). K14's rows are K11/K12's kernel on K14's class: they read
K11/K12's counters, on the ell-allgather solves of the permuted twin.

Each phase prints its seconds. The line before the last is the kernels' JSON; the last line is
``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import io
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import torch

# kernel -> (source, the TPU kernel it replaces)
KERNELS = {
    "K1 stencil spmv": ("hpccg_tpu_torch/csrc/stencil.cu", "hpccg_tpu/ops/pallas/stencil_v2.py:133"),
    "K2 stencil spmv + p.Ap": ("hpccg_tpu_torch/csrc/stencil.cu", "hpccg_tpu/ops/pallas/stencil_v2.py:280"),
    "K3 p-update + spmv + p.Ap": ("hpccg_tpu_torch/csrc/stencil.cu", "hpccg_tpu/ops/pallas/fused_cg.py:68"),
    "K4 x/r update + r.r": ("hpccg_tpu_torch/csrc/fused_cg.cu", "hpccg_tpu/ops/pallas/fused_cg.py:114"),
    "finalize (partials + CG scalars)": ("hpccg_tpu_torch/csrc/fused_cg.cu", "hpccg_tpu/ops/pallas/fused_cg.py:107"),
    "K5 whole solve (megakernel)": ("hpccg_tpu_torch/csrc/wholesolve.cu", "hpccg_tpu/ops/pallas/megakernel.py:119"),
    "K6 whole solve, Ap recomputed (streamkernel)": ("hpccg_tpu_torch/csrc/wholesolve.cu",
                                                     "hpccg_tpu/ops/pallas/streamkernel.py:92"),
    "K7 f64 stencil (pallas_dd)": ("hpccg_tpu_torch/csrc/stencil.cu", "hpccg_tpu/ops/pallas/stencil_v2.py:496"),
    "K9 DIA spmv": ("hpccg_tpu_torch/csrc/dia.cu", "hpccg_tpu/ops/pallas/dia_kernel.py:76"),
    "K10 f64 DIA spmv": ("hpccg_tpu_torch/csrc/dia.cu", "hpccg_tpu/ops/pallas/dia_kernel.py:425"),
    "K11 ELL gather spmv": ("hpccg_tpu_torch/csrc/ell.cu", "hpccg_tpu/ops/pallas/gell_kernel.py:572"),
    "K12 f64 ELL gather spmv": ("hpccg_tpu_torch/csrc/ell.cu", "hpccg_tpu/ops/pallas/gell_kernel.py:618"),
    "K13 wide scatter, strip stack (relabelled ELL gather)": ("hpccg_tpu_torch/csrc/ell_scatter.cu",
                                                               "hpccg_tpu/ops/pallas/gell_stack.py:424"),
    "K14 wide scatter, dynamic window (K11's ELL gather, in place)": ("hpccg_tpu_torch/csrc/ell.cu",
                                                                       "hpccg_tpu/ops/pallas/gell_dynwin.py:336"),
    "K15 collective whole solve (cg, cg1)": ("hpccg_tpu_torch/csrc/collective.cu",
                                             "hpccg_tpu/ops/pallas/collective_kernel.py:329"),
    "K16 pipelined collective whole solve": ("hpccg_tpu_torch/csrc/collective.cu",
                                             "hpccg_tpu/ops/pallas/collective_kernel.py:596"),
    "K17 collective DIA whole solve (cg, cg1)": ("hpccg_tpu_torch/csrc/collective_dia.cu",
                                                 "hpccg_tpu/ops/pallas/collective_kernel.py:906"),
    "K1/bf16 stencil spmv": ("hpccg_tpu_torch/csrc/stencil.cu", "hpccg_tpu/ops/pallas/stencil_v2.py:133"),
    "K2/bf16 stencil spmv + p.Ap": ("hpccg_tpu_torch/csrc/stencil.cu", "hpccg_tpu/ops/pallas/stencil_v2.py:280"),
    "K3/bf16 p-update + spmv + p.Ap": ("hpccg_tpu_torch/csrc/stencil.cu", "hpccg_tpu/ops/pallas/fused_cg.py:68"),
    "K4/bf16 x/r update + r.r": ("hpccg_tpu_torch/csrc/fused_cg.cu", "hpccg_tpu/ops/pallas/fused_cg.py:114"),
    "copy-probe y = x + 1 (HBM copy rate)": ("hpccg_tpu_torch/csrc/stream.cu", "exp/stream_probe.py:25"),
    "write-probe o = tile(seed) * 1.00001 (HBM write rate)": ("hpccg_tpu_torch/csrc/stream.cu",
                                                             "exp/rw_probe.py:20"),
    "K15/bf16 collective whole solve (cg, cg1)": ("hpccg_tpu_torch/csrc/collective.cu",
                                                  "hpccg_tpu/ops/pallas/collective_kernel.py:329"),
    "K16/bf16 pipelined collective whole solve": ("hpccg_tpu_torch/csrc/collective.cu",
                                                  "hpccg_tpu/ops/pallas/collective_kernel.py:596"),
    "K9/bf16 DIA spmv": ("hpccg_tpu_torch/csrc/dia.cu", "hpccg_tpu/ops/pallas/dia_kernel.py:76"),
    "K9/bf16 DIA spmv, window instance (dia-halo)": ("hpccg_tpu_torch/csrc/dia.cu",
                                                     "hpccg_tpu/ops/pallas/dia_kernel.py:76"),
    "K11/bf16 ELL gather spmv": ("hpccg_tpu_torch/csrc/ell.cu", "hpccg_tpu/ops/pallas/gell_kernel.py:572"),
    "K3 p-update + spmv + p.Ap, 256^3": ("hpccg_tpu_torch/csrc/stencil.cu", "hpccg_tpu/ops/pallas/fused_cg.py:68"),
    "K4 x/r update + r.r, 256^3": ("hpccg_tpu_torch/csrc/fused_cg.cu", "hpccg_tpu/ops/pallas/fused_cg.py:114"),
    "K5 whole solve (megakernel), 256^3": ("hpccg_tpu_torch/csrc/wholesolve.cu",
                                           "hpccg_tpu/ops/pallas/megakernel.py:119"),
    "K6 whole solve, Ap recomputed (streamkernel), 256^3": ("hpccg_tpu_torch/csrc/wholesolve.cu",
                                                            "hpccg_tpu/ops/pallas/streamkernel.py:92"),
    "K5/bf16 whole solve (megakernel), 256^3": ("hpccg_tpu_torch/csrc/wholesolve.cu",
                                                "hpccg_tpu/ops/pallas/megakernel.py:119"),
    "K6/bf16 whole solve, Ap recomputed (streamkernel), 256^3": ("hpccg_tpu_torch/csrc/wholesolve.cu",
                                                                 "hpccg_tpu/ops/pallas/streamkernel.py:92"),
    "K15 collective whole solve (cg, cg1), 4 x 100^3": ("hpccg_tpu_torch/csrc/collective.cu",
                                                        "hpccg_tpu/ops/pallas/collective_kernel.py:329"),
    "K16 pipelined collective whole solve, 4 x 100^3": ("hpccg_tpu_torch/csrc/collective.cu",
                                                        "hpccg_tpu/ops/pallas/collective_kernel.py:596"),
    "K17 collective DIA whole solve (cg, cg1), f64": ("hpccg_tpu_torch/csrc/collective_dia.cu",
                                                      "hpccg_tpu/ops/pallas/collective_kernel.py:906"),
    "K13 f64 wide scatter, strip stack (relabelled ELL gather)": ("hpccg_tpu_torch/csrc/ell_scatter.cu",
                                                                   "hpccg_tpu/ops/pallas/gell_stack.py:482"),
    "K14 f64 wide scatter, dynamic window (K12's ELL gather, in place)": ("hpccg_tpu_torch/csrc/ell.cu",
                                                                           "hpccg_tpu/ops/pallas/gell_dynwin.py:393"),
    "K3 p-update + spmv + p.Ap without the Ap' store, 300^3 f64": ("hpccg_tpu_torch/csrc/stencil.cu",
                                                                    "hpccg_tpu/ops/pallas/fused_cg.py:68"),
    "K4s x/r update + r.r, Ap' recomputed, 300^3 f64": ("hpccg_tpu_torch/csrc/stencil.cu",
                                                         "hpccg_tpu/ops/pallas/fused_cg.py:114"),
}
SLICE1 = list(KERNELS)[:5]  # the kernels of slice 1's main path
SLICE2 = list(KERNELS)[5:8]
SLICE3 = list(KERNELS)[8:14]
SLICE4 = list(KERNELS)[14:16]
SLICE5 = list(KERNELS)[16:17]
SLICE6 = list(KERNELS)[17:23]
SLICE7 = list(KERNELS)[23:28]
SLICE8 = list(KERNELS)[28:30]
SLICE9 = list(KERNELS)[30:34]
SLICE10 = list(KERNELS)[34:36]
SLICE11 = list(KERNELS)[36:37]
SLICE12 = list(KERNELS)[37:39]
SLICE16 = list(KERNELS)[39:]
K4 = SLICE1[3]
K5, K6, K7 = SLICE2
K9, K10, K11, K12, K13, K14 = SLICE3
K15, K16 = SLICE4
(K17,) = SLICE5
B1, B2, B3, B4, COPY, WRITE = SLICE6
C15, C16, D9, D9W, E11 = SLICE7
BIG3, BIG4 = SLICE8
BIG5, BIG6, BIG5B, BIG6B = SLICE9
BIG15, BIG16 = SLICE10
(K17D,) = SLICE11
K13D, K14D = SLICE12
K3N, K4S = SLICE16
WIDE = [K13, K14, K13D, K14D]
WIDE13, WIDE14 = [K13, K13D], [K14, K14D]  # counted on the wide-scatter solves as loaded, on one device and in place
# rows that read another row's counter (K14's rows K11's and K12's) or a
# part of it (K3 without the Ap' store: K3's launches of that form)
SHARED = [K14, K14D, K3N]
# tolerances, kernel vs plain on the same inputs: the sums run in another
# order (the xy-sums associate like the plain version, but the compiler may
# contract into FMAs, and the dots are per-block trees)
# (bf16: K9/K11's bf16 instances are held bit for bit; this is half a bf16 ulp)
VEC_RTOL = {torch.float32: 1e-5, torch.float64: 1e-13, torch.bfloat16: 2.0**-8}  # max|a-b| / max|b|
DOT_RTOL = {torch.float32: 1e-4, torch.float64: 1e-12}  # |a-b| / |b|
SHAPES = [(33, 17, 9), (100, 100, 100), (64, 48, 130)]
MAIN_SHAPE = (100, 100, 100)
# whole solve, kernel vs plain over 30 iterations: (trace rtol, floor). The
# trace is held to rtol while it stays above floor * trace[0]; the solve is
# stopped there by a tolerance between two of the plain version's trace
# entries, so both exit at the same k: below the floor the recurrence
# follows each run's rounding (and 7-point f32 runs flush r.r to 0 within
# 30 iterations). bf16: the two round p', Ap', r and x to bf16 at the same
# places, but sum in other orders and contract into FMAs in other places,
# so now and then an element of r rounds the other way, and the traces part
# slowly. Its limits are about twice the largest readings on an H100
# (PERF.md, Findings): trace 7.3e-3, x 2 ulps in 3.1e-4 of the elements (K6,
# 256^3, 50 iterations). A skipped rounding point would move most of x.
WS_TRACE = {torch.float32: (1e-4, 1e-5), torch.float64: (1e-10, 1e-11), torch.bfloat16: (1.5e-2, 1e-4)}
WS_X_RTOL = {torch.float32: 1e-5, torch.float64: 1e-12}  # max|a-b| / max|b|
# bf16 x: the largest distance in units in the last place, and the share
# of the elements that differ at all
WS_X_ULPS, WS_X_SHARE = 4, 1e-3
# a shape with more work items than the grid has blocks in every dtype, so
# that blocks take several items in turns (the shapes above, and
# 200x170x150, give each block one)
WS_MULTI_SHAPE = (300, 301, 250)
WS_SHAPES = [*SHAPES, (200, 170, 150), WS_MULTI_SHAPE]


def say(msg: str) -> None:
    print(msg, flush=True)


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda is not available; this check needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    card = smi.stdout.strip().splitlines()[0]
    say(card)
    say(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} devices {torch.cuda.device_count()}")
    from hpccg_tpu_torch.ops.cuda.build import nvcc_path

    ver = subprocess.run([nvcc_path(), "--version"], capture_output=True, text=True, timeout=60)
    say(f"[device] nvcc: {ver.stdout.strip().splitlines()[-1]}")
    return card


def phase_build() -> None:
    from hpccg_tpu_torch.ops.cuda import build

    t0 = time.perf_counter()
    compiled = build.build()
    build.load_library()
    say(f"[build] nvcc {compiled:.1f} s (load {time.perf_counter() - t0:.1f} s) -> "
        f"{build.BUILD_DIR / build.LIB_NAME}")
    for line in (build.BUILD_DIR / "nvcc.log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            say(f"[build] {line.strip()}")


def _vec_err(a, b, dtype, what):
    err = float((a - b).abs().max())
    scale = float(b.abs().max()) or 1.0
    if not err <= VEC_RTOL[dtype] * scale:
        raise AssertionError(f"{what}: max|kernel - plain| = {err:.3e} > {VEC_RTOL[dtype]} * {scale:.3e}")
    return err


def _dot_err(a, b, dtype, what):
    a, b = float(a), float(b)
    if not abs(a - b) <= DOT_RTOL[dtype] * abs(b):
        raise AssertionError(f"{what}: kernel {a!r} vs plain {b!r} (rtol {DOT_RTOL[dtype]})")
    return abs(a - b)


def _profile(fn, reps, kernel) -> list:
    """The card's kernel events (torch.profiler's key_averages) over
    ``reps`` calls of fn. The profiler drops device events now and then
    (PERF.md, PR 3): a profile that holds fewer than ``reps`` launches of a
    kernel whose name contains ``kernel`` is taken again, up to 3 times."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [ev for ev in prof.key_averages() if ev.device_type == torch.autograd.DeviceType.CUDA]
        if sum(ev.count for ev in events if kernel in ev.key) >= reps:
            return events
        say(f"[timing] torch.profiler dropped device events (want {reps} launches of {kernel}); profiling again")
    raise AssertionError("torch.profiler recorded too few device events three times")


def phase_kernels() -> dict:
    """Kernel vs plain; returns per-kernel max_abs_err/ms/plain_ms at the
    main path's shape (100^3, 27-point, float32)."""
    from hpccg_tpu_torch.config import Stencil
    from hpccg_tpu_torch.operators import StencilOperator
    from hpccg_tpu_torch.ops.cuda import fused_cg as fc
    from hpccg_tpu_torch.ops.cuda import stencil as st

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1234)
    stats = {name: {"max_abs_err": 0.0} for name in KERNELS}
    names = list(KERNELS)
    for nx, ny, nz in SHAPES:
        for stencil in (Stencil.S27, Stencil.S7):
            for dtype in (torch.float32, torch.float64):
                op = StencilOperator(nx, ny, nz, stencil, dtype)
                tag = f"{nx}x{ny}x{nz} {stencil.value}pt {str(dtype)[6:]}"
                main = (nx, ny, nz) == MAIN_SHAPE and stencil == Stencil.S27 and dtype == torch.float32

                def rnd(*shape):
                    return torch.randn(shape, generator=gen, device=dev, dtype=dtype)

                grid = (nz, ny, nx)
                u, r, p = rnd(*grid), rnd(*grid), rnd(*grid)
                halo2, halo4 = rnd(2, ny, nx), rnd(4, ny, nx)
                beta = torch.tensor([0.37], device=dev, dtype=dtype)
                errs = {}
                # K1, without and with external halo planes
                e = 0.0
                for halo in (None, halo2):
                    e = max(e, _vec_err(st.spmv_stencil(op, u, halo), st.spmv_stencil_plain(op, u, halo),
                                        dtype, f"K1 {tag} halo={halo is not None}"))
                errs[names[0]] = e
                # K2
                y, parts = st.spmv_stencil_pap(op, u, halo2)
                y0, parts0 = st.spmv_stencil_pap_plain(op, u, halo2)
                errs[names[1]] = _vec_err(y, y0, dtype, f"K2 y {tag}")
                _dot_err(parts.sum(), parts0.sum(), dtype, f"K2 p.Ap {tag}")
                # K3, with a nonzero beta, with and without halos
                e = 0.0
                for halo in (None, halo4):
                    pp, ap, parts = st.update_p_apply(op, r, p, beta, halo)
                    pp0, ap0, parts0 = st.update_p_apply_plain(op, r, p, beta, halo)
                    e = max(e, _vec_err(pp, pp0, dtype, f"K3 p' {tag}"),
                            _vec_err(ap, ap0, dtype, f"K3 Ap' {tag}"))
                    _dot_err(parts.sum(), parts0.sum(), dtype, f"K3 p'.Ap' {tag}")
                errs[names[2]] = e
                # K4 (in place: both versions get their own copies)
                alpha = torch.tensor([0.21], device=dev, dtype=dtype)
                ap = rnd(*grid)
                x1, r1, x2, r2 = u.clone(), r.clone(), u.clone(), r.clone()
                _, _, parts = fc.update_x_r(x1, r1, p, ap, alpha)
                _, _, parts0 = fc.update_x_r_plain(x2, r2, p, ap, alpha)
                errs[names[3]] = max(_vec_err(x1, x2, dtype, f"K4 x' {tag}"),
                                     _vec_err(r1, r2, dtype, f"K4 r' {tag}"))
                _dot_err(parts.sum(), parts0.sum(), dtype, f"K4 r'.r' {tag}")
                # finalize: the same step sequence on two copies of a state
                errs[names[4]] = _check_finalize(fc, dtype, dev, gen, tag)
                if dtype == torch.float64:  # K7: K2's float64 instance (pallas_dd)
                    y, parts = st.spmv_stencil_pap_dd(op, u, halo2)
                    y0, parts0 = st.spmv_stencil_pap_plain(op, u, halo2)
                    errs[K7] = _vec_err(y, y0, dtype, f"K7 y {tag}")
                    _dot_err(parts.sum(), parts0.sum(), dtype, f"K7 p.Ap {tag}")
                    if (nx, ny, nz) == MAIN_SHAPE and stencil == Stencil.S27:
                        stats[K7]["max_abs_err"] = errs[K7]
                        _time_pair(stats[K7], lambda: st.spmv_stencil_pap_dd(op, u),
                                   lambda: st.spmv_stencil_pap_plain(op, u))
                        _model(stats[K7], 2 * op.local_nrow * 8, 2 * op.nnz + 2 * op.local_nrow, 8)
                if main:
                    for name in SLICE1:
                        stats[name]["max_abs_err"] = errs[name]
                    _time_kernels(st, fc, op, u, r, p, beta, stats, names)
                say(f"[kernels] {tag}: ok " + " ".join(f"{n.split()[0]}={e:.2e}" for n, e in errs.items()))
    return stats


def _bits(t):
    """t's bits as integers: two solves are bit-identical iff these are equal
    (NaN entries included)."""
    return t.view({2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()])


def _ws_tolerance(trace, floor):
    """A tolerance between the first two entries of a (plain) trace that
    straddle floor * trace[0], or 0 if it never goes below."""
    below = torch.nonzero(trace < floor * trace[0])
    if below.numel() == 0:
        return 0.0
    k = int(below[0])
    return float(torch.sqrt(trace[k - 1] * trace[k]))


def _ulps(a, b) -> int:
    """The largest distance between two bf16 tensors in units in the last
    place (adjacent bf16 values are 1 apart, across 0 as well)."""
    def ordered(t):
        v = t.view(torch.int16).to(torch.int32)
        return torch.where(v < 0, -32768 - v, v)

    return int((ordered(a) - ordered(b)).abs().max())


def _ulp_note(got, want) -> str:
    if got.dtype != torch.bfloat16:
        return ""
    return f" ({_ulps(got, want)} ulps, {int((got != want).sum())} elements)"


def _x_check(got, want, what) -> float:
    """x of a kernel solve against its plain version's: for bf16 within
    WS_X_ULPS, with at most WS_X_SHARE of the elements different; within
    WS_X_RTOL of max|x| otherwise. Returns max|got - want|."""
    err = float((got.double() - want.double()).abs().max())
    if got.dtype == torch.bfloat16:
        share = float((got != want).double().mean())
        if not (_ulps(got, want) <= WS_X_ULPS and share <= WS_X_SHARE):
            raise AssertionError(f"{what}: x {_ulps(got, want)} bf16 ulps from the plain version's in "
                                 f"{share:.2e} of the elements (limits {WS_X_ULPS}, {WS_X_SHARE})")
    elif not err <= WS_X_RTOL[got.dtype] * float(want.double().abs().max()):
        raise AssertionError(f"{what}: max|x - x_plain| = {err:.3e}")
    return err


def _ws_case(kern, plain, A, b, x0, dtype, what) -> tuple:
    """One whole-solve kernel against its plain version, max_iter 30, stopped
    by a tolerance between the plain trace's entries that straddle
    WS_TRACE's floor: niters equal, the trace within its rtol, x as
    _x_check holds it, two kernel solves bit-identical. Returns (niters,
    tol, trace gap, max|x - x_plain|, bf16: the ulps note)."""
    rtol, floor = WS_TRACE[dtype]
    tol = _ws_tolerance(plain(A, b, x0, max_iter=30).trace, floor)
    want = plain(A, b, x0, max_iter=30, tolerance=tol)
    got, again = (kern(A, b, x0, max_iter=30, tolerance=tol) for _ in range(2))
    torch.cuda.synchronize()
    if int(got.niters) != int(want.niters):
        raise AssertionError(f"{what}: niters {int(got.niters)} vs plain {int(want.niters)}")
    n = int(want.niters) + 1
    rel = float(((got.trace[:n] - want.trace[:n]).abs() / want.trace[:n]).max())
    if not rel <= rtol or not bool(torch.isnan(got.trace[n:]).all()):
        raise AssertionError(f"{what}: trace {got.trace[:n].tolist()} vs plain {want.trace[:n].tolist()}")
    xerr = _x_check(got.x, want.x, what)
    if not (torch.equal(_bits(got.trace), _bits(again.trace)) and torch.equal(_bits(got.x), _bits(again.x))):
        raise AssertionError(f"{what}: two kernel solves differ")
    return n - 1, tol, rel, xerr, _ulp_note(got.x, want.x)


WS_EDGES = ["nx<V", "nx=100", "nx=TX-1", "nx=TX+1", "ny%TY", "nz=ZC-1", "nz=ZC+1"]


def _ws_edge_shape(edge, dtype, stencil, recompute_ap):
    """(nx, ny, nz) at ``edge`` of the whole-solve kernel's geometry for
    dtype: a thread's V points, the tile's width TX = 32 V and height TY,
    and the z chunk ZC, which the kernel picks per grid: the z edges are
    grids whose chosen chunk is one above or below their nz (the largest
    chunk for which the search finds one)."""
    from hpccg_tpu_torch.config import Stencil
    from hpccg_tpu_torch.operators import StencilOperator
    from hpccg_tpu_torch.ops.cuda import wholesolve as ws

    def geo(nx, ny, nz):
        return ws.geometry(StencilOperator(nx, ny, nz, Stencil(stencil), dtype), dtype, recompute_ap)

    g = geo(64, 64, 64)
    tx, ty = g.tile_x, g.tile_y
    shapes = {"nx<V": (max(tx // 32 - 1, 1), ty + 3, 5), "nx=100": (100, ty + 3, 7), "nx=TX-1": (tx - 1, ty + 1, 6),
              "nx=TX+1": (tx + 1, 2 * ty + 1, 5), "ny%TY": (33, 3 * ty + 5, 9)}
    if edge in shapes:
        return shapes[edge]
    zc = geo(tx * 8, ty * 128, 4096).z_chunk
    while zc >= 2:
        nz = zc - 1 if edge == "nz=ZC-1" else zc + 1
        for ky in range(1, 4096):
            if geo(tx + 1, ty * ky + 1, nz).z_chunk == zc:
                return tx + 1, ty * ky + 1, nz
        zc //= 2
    raise AssertionError(f"no grid at {edge}")


def phase_whole_solve_kernels() -> dict:
    """K5 and K6 against their plain versions (_ws_case), float32, float64
    and bfloat16, 27- and 7-point: on WS_SHAPES (at WS_MULTI_SHAPE with more
    work items than blocks), on grids at the edges of their tile, and with b
    and x0 views at odd element offsets (a random x0 bit for bit with the
    solve on aligned copies). Returns K5/K6's max_abs_err (x at
    100^3 27-point float32) and their us/iter against the plain versions'."""
    from hpccg_tpu_torch import ProblemConfig, generate_problem
    from hpccg_tpu_torch.ops.cuda import megakernel as mk
    from hpccg_tpu_torch.ops.cuda import streamkernel as sk
    from hpccg_tpu_torch.ops.cuda import wholesolve as ws

    pairs = {K5: (mk.cg_solve_mega, mk.cg_solve_mega_plain),
             K6: (sk.cg_solve_stream, sk.cg_solve_stream_plain)}
    stats = {name: {"max_abs_err": 0.0} for name in pairs}
    dtypes = (torch.float32, torch.float64, torch.bfloat16)
    for dims in WS_SHAPES:
        for stencil in (27, 7):
            for dtype in dtypes:
                prob = generate_problem(ProblemConfig(*dims, stencil=stencil, dtype=dtype), device="cuda")
                tag = f"{dims[0]}x{dims[1]}x{dims[2]} {stencil}pt {str(dtype)[6:]}"
                line = []
                for name, (kern, plain) in pairs.items():
                    what = f"{name.split()[0]} {tag}"
                    g = ws.geometry(prob.A, dtype, name == K6)
                    if dims == WS_MULTI_SHAPE and not g.items > g.blocks:
                        raise AssertionError(f"{what}: {g.items} work items for {g.blocks} blocks")
                    k, tol, rel, xerr, ulp = _ws_case(kern, plain, prob.A, prob.b, prob.x0, dtype, what)
                    if dims == MAIN_SHAPE and stencil == 27 and dtype == torch.float32:
                        stats[name]["max_abs_err"] = xerr
                    line.append(f"{name.split()[0]} zc {g.z_chunk} {g.items} items/{g.blocks} blocks niters {k} "
                                f"(tol {tol:.3g}) trace {rel:.2e} x {xerr:.2e}{ulp}")
                say(f"[whole-solve] {tag}: ok, bit-identical; " + "; ".join(line))
    for dtype in dtypes:
        for stencil in (27, 7):
            for name, (kern, plain) in pairs.items():
                for edge in WS_EDGES:
                    dims = _ws_edge_shape(edge, dtype, stencil, name == K6)
                    prob = generate_problem(ProblemConfig(*dims, stencil=stencil, dtype=dtype), device="cuda")
                    what = f"{name.split()[0]} {edge} {dims[0]}x{dims[1]}x{dims[2]} {stencil}pt {str(dtype)[6:]}"
                    g = ws.geometry(prob.A, dtype, name == K6)
                    k, _, rel, xerr, ulp = _ws_case(kern, plain, prob.A, prob.b, prob.x0, dtype, what)
                    say(f"[whole-solve edges] {what} (zc {g.z_chunk}, {g.items} items/{g.blocks} blocks): ok, "
                        f"niters {k} trace {rel:.2e} x {xerr:.2e}{ulp}")
        # b and x0 as views at element offsets 1 and 3, which init stages on narrower accesses: on a random x0
        # bit for bit with aligned copies, on the problem's own b and x0 against the plain version
        prob = generate_problem(ProblemConfig(100, 9, 7, dtype=dtype), device="cuda")
        n = prob.b.numel()
        gen = torch.Generator(device="cuda").manual_seed(909)

        def view(t, offset):
            out = torch.empty((n + offset,), device="cuda", dtype=dtype)[offset:]
            return out.copy_(t)

        rand = torch.randn((n,), generator=gen, device="cuda", dtype=torch.float64).to(dtype)
        for name, (kern, plain) in pairs.items():
            what = f"{name.split()[0]} views at offsets 1/3 100x9x7 {str(dtype)[6:]}"
            got = kern(prob.A, view(prob.b, 1), view(rand, 3), max_iter=30)
            want = kern(prob.A, prob.b, rand, max_iter=30)
            if not (torch.equal(_bits(got.x), _bits(want.x)) and torch.equal(_bits(got.trace), _bits(want.trace))):
                raise AssertionError(f"{what}: the solve on views differs from the solve on aligned copies")
            k, _, rel, xerr, ulp = _ws_case(kern, plain, prob.A, view(prob.b, 1), view(prob.x0, 3), dtype, what)
            say(f"[whole-solve views] {what}: ok, random x0 bit for bit with aligned copies; the problem's b and "
                f"x0 niters {k} trace {rel:.2e} x {xerr:.2e}{ulp}")
    from hpccg_tpu_torch.utils.timing import time_loop_slope

    prob = generate_problem(ProblemConfig(*MAIN_SHAPE, dtype=torch.float32), device="cuda")
    for name, (kern, plain) in pairs.items():
        # us per CG iteration, slope-timed; plain, kernel, kernel, plain
        def per_iter(fn):
            return time_loop_slope(lambda k: fn(prob.A, prob.b, prob.x0, max_iter=k + 1), device="cuda",
                                   short=17, long=145, reps=3) * 1e3

        t_plain1, t_k1, t_k2, t_plain2 = (per_iter(f) for f in (plain, kern, kern, plain))
        stats[name]["ms"] = (t_k1 + t_k2) / 2
        stats[name]["plain_ms"] = (t_plain1 + t_plain2) / 2
        # one CG iteration: its state x, r, p read and written once
        _model(stats[name], 6 * prob.total_nrow * 4, 2 * prob.A.nnz + 10 * prob.total_nrow, 4)
        say(f"[whole-solve] {name}: {stats[name]['ms'] * 1e3:.2f} us/iter vs plain "
            f"{stats[name]['plain_ms'] * 1e3:.2f} at 100^3 float32")
    return stats


def phase_whole_solve_256(card: str) -> dict:
    """K5 and K6 at 256^3 (past the L2) in float32 and bfloat16, the kernels
    line's 256^3 rows: us per CG iteration slope-timed (legs of 17 and 145;
    plain, kernel, kernel, plain) and modelled as the 100^3 rows. Their
    max_abs_err is the main path's (slice 2 holds these solves against the
    plain versions: _against_plain)."""
    from hpccg_tpu_torch import ProblemConfig, generate_problem
    from hpccg_tpu_torch.ops.cuda import megakernel as mk
    from hpccg_tpu_torch.ops.cuda import streamkernel as sk
    from hpccg_tpu_torch.ops.cuda import wholesolve as ws
    from hpccg_tpu_torch.utils.timing import time_loop_slope

    rows = {torch.float32: ((BIG5, mk.cg_solve_mega, mk.cg_solve_mega_plain),
                            (BIG6, sk.cg_solve_stream, sk.cg_solve_stream_plain)),
            torch.bfloat16: ((BIG5B, mk.cg_solve_mega, mk.cg_solve_mega_plain),
                             (BIG6B, sk.cg_solve_stream, sk.cg_solve_stream_plain))}
    stats = {}
    for dtype, kernels in rows.items():
        prob = generate_problem(ProblemConfig(*BIG_SHAPE, dtype=dtype), device="cuda")
        args = (prob.A, prob.b, prob.x0)
        for name, kern, plain in kernels:
            def per_iter(fn):
                return time_loop_slope(lambda k: fn(*args, max_iter=k + 1), device="cuda", short=17, long=145,
                                       reps=3) * 1e3

            stat = stats[name] = {}
            t_plain1, t_k1, t_k2, t_plain2 = (per_iter(f) for f in (plain, kern, kern, plain))
            stat["ms"], stat["plain_ms"] = (t_k1 + t_k2) / 2, (t_plain1 + t_plain2) / 2
            elsize = prob.b.element_size()
            _model(stat, 6 * prob.total_nrow * elsize, 2 * prob.A.nnz + 10 * prob.total_nrow, elsize)
            g = ws.geometry(prob.A, dtype, kern is sk.cg_solve_stream)
            say(f"[whole-solve 256^3] {name}: {stat['ms'] * 1e3:.2f} us/iter vs plain "
                f"{stat['plain_ms'] * 1e3:.2f}, bound {_bound(stat)[0] * 1e3:.2f} (zc {g.z_chunk}, {g.items} "
                f"items/{g.blocks} blocks) [{card}]")
    return stats


def phase_large_offsets() -> None:
    """K1 and K4 past 2^31 elements (64-bit offsets): the top planes and the
    last elements against the plain versions on slices."""
    from hpccg_tpu_torch.operators import StencilOperator
    from hpccg_tpu_torch.ops.cuda import fused_cg as fc
    from hpccg_tpu_torch.ops.cuda import stencil as st

    nx, ny, nz = 1024, 1024, 2049  # 2,148,532,224 points > 2^31
    gen = torch.Generator(device="cuda").manual_seed(7)
    op = StencilOperator(nx, ny, nz)
    u = torch.rand((nz, ny, nx), generator=gen, device="cuda", dtype=torch.float32)
    y = st.spmv_stencil(op, u)
    top = StencilOperator(nx, ny, 3)
    want = st.spmv_stencil_plain(top, u[-3:].contiguous(), torch.stack([u[-4], torch.zeros_like(u[0])]))
    err = _vec_err(y[-3:], want, torch.float32, "K1 past 2^31")
    del y
    n = u.numel()
    x, r = u.view(-1), torch.rand((n,), generator=gen, device="cuda", dtype=torch.float32)
    p = r.flip(0)
    alpha = torch.tensor([0.5], device="cuda")
    tail = slice(n - 4096, n)
    x0, r0, p0 = x[tail].clone(), r[tail].clone(), p[tail].clone()
    fc.update_x_r(x, r, p, p, alpha)
    fc.update_x_r_plain(x0, r0, p0, p0, alpha)
    err = max(err, _vec_err(x[tail], x0, torch.float32, "K4 x past 2^31"),
              _vec_err(r[tail], r0, torch.float32, "K4 r past 2^31"))
    torch.cuda.synchronize()
    say(f"[kernels] {nx}x{ny}x{nz} f32 ({n} points, past 2^31): K1 top planes and K4 tail ok, "
        f"max err {err:.2e}")


def _check_finalize(fc, dtype, dev, gen, tag) -> float:
    states = [fc.CGScalars.new(dtype, 6, 1e-30, dev) for _ in range(2)]
    err = 0.0
    steps = [fc.STEP_INIT] + [fc.STEP_PAP, fc.STEP_RR] * 6  # runs past the exit
    for i, step in enumerate(steps):
        parts = torch.rand((700,), generator=gen, device=dev, dtype=dtype) + 0.5
        fc.cg_finalize(parts, states[0], step)
        fc.cg_finalize_plain(parts, states[1], step)
        a, b = states
        if not torch.equal(a.ic, b.ic):
            raise AssertionError(f"finalize {tag} step {i}: ic {a.ic.tolist()} vs {b.ic.tolist()}")
        if not torch.equal(torch.isnan(a.trace), torch.isnan(b.trace)):
            raise AssertionError(f"finalize {tag} step {i}: trace {a.trace.tolist()} vs {b.trace.tolist()}")
        fin = ~torch.isnan(b.trace)
        err = max(err, _vec_err(a.sc, b.sc, dtype, f"finalize sc {tag} step {i}"),
                  _vec_err(a.trace[fin], b.trace[fin], dtype, f"finalize trace {tag} step {i}"))
    if int(states[0].ic[fc.IC_ACTIVE]) != 0 or int(states[0].ic[fc.IC_K]) != 6:
        raise AssertionError(f"finalize {tag}: expected an exit at k=6, got ic={states[0].ic.tolist()}")
    return err


def _time_kernels(st, fc, op, u, r, p, beta, stats, names) -> None:
    out, out2 = torch.empty_like(u), torch.empty_like(u)
    parts3 = torch.empty((st.num_partials(op, u.device),), device=u.device, dtype=u.dtype)
    pairs = {
        names[0]: (lambda: st.spmv_stencil(op, u, out=out), lambda: st.spmv_stencil_plain(op, u, out=out)),
        names[1]: (lambda: st.spmv_stencil_pap(op, u, out=out, partials=parts3),
                   lambda: st.spmv_stencil_pap_plain(op, u, out=out)),
        names[2]: (lambda: st.update_p_apply(op, r, p, beta, out_p=out, out_ap=out2, partials=parts3),
                   lambda: st.update_p_apply_plain(op, r, p, beta, out_p=out, out_ap=out2)),
    }
    x, rr, ap = u.clone(), r.clone(), p.clone()
    alpha = torch.zeros((1,), device=u.device, dtype=u.dtype)  # keeps x, r unchanged
    parts4 = torch.empty((fc.num_update_partials(x.numel(), x.device),), device=x.device, dtype=x.dtype)
    pairs[names[3]] = (lambda: fc.update_x_r(x, rr, p, ap, alpha, partials=parts4),
                       lambda: fc.update_x_r_plain(x, rr, p, ap, alpha))
    state = fc.CGScalars.new(u.dtype, 10**9, 0.0, u.device)
    fc.cg_finalize(parts3, state, fc.STEP_INIT)
    pairs[names[4]] = (lambda: fc.cg_finalize(parts3, state, fc.STEP_PAP),
                       lambda: fc.cg_finalize_plain(parts3, state, fc.STEP_PAP))
    for name, (kern, plain) in pairs.items():
        _time_pair(stats[name], kern, plain)
    n, s4, nnz = op.local_nrow, u.element_size(), op.nnz
    _model(stats[names[0]], 2 * n * s4, 2 * nnz, s4)
    _model(stats[names[1]], 2 * n * s4, 2 * nnz + 2 * n, s4)
    _model(stats[names[2]], 4 * n * s4, 2 * nnz + 4 * n, s4)
    _model(stats[names[3]], 6 * n * s4, 6 * n, s4)
    _model(stats[names[4]], parts3.numel() * s4, parts3.numel(), s4)
    weight, u5 = _conv_weight(op), u.view(1, 1, *u.shape)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False  # the same f32 function, not TF32's
    try:
        stats[names[0]]["library_ms"] = _event_ms(lambda: torch.nn.functional.conv3d(u5, weight, padding=1))
    finally:
        torch.backends.cudnn.allow_tf32 = tf32


def _graph_ms(fn, reps=20) -> float:
    """Device ms per call of fn: ``reps`` calls captured in one CUDA graph
    and replayed between two CUDA events. Neither the host (each wrapper
    call costs more host time than a 100^3 kernel takes on the card) nor
    the profiler is in the measurement: torch.profiler drops device events
    now and then (one run read K12 at 4.2 TB/s, past the card's 3.35,
    PERF.md, PR 3)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _event_ms(fn, reps=20) -> float:
    """Device ms per call of fn: CUDA events around ``reps`` calls after a
    warm-up (for library calls that a CUDA graph may not capture)."""
    fn()
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


# the card's rates for the bounds: HBM and peak arithmetic without tensor
# cores (float32 and float64: NVIDIA's H100 SXM data sheet), at the full
# 700 W power limit
HBM_BYTES_PER_S = 3.35e12
# bf16 storage (element size 2) computes in float32: its peak is float32's
PEAK_OPS_PER_S = {2: 67e12, 4: 67e12, 8: 34e12}


def _model(stat, nbytes, ops, elsize) -> None:
    """The work of one timed call: bytes that must move (each input read
    once, each output written once) and arithmetic operations."""
    stat.update(bytes=nbytes, ops=ops, elsize=elsize)


def _bound(stat):
    """(bound_ms, bound_by) of a timed call: the larger of its bytes over
    the HBM rate and its operations over the peak rate."""
    t_bytes = stat["bytes"] / HBM_BYTES_PER_S
    t_ops = stat["ops"] / PEAK_OPS_PER_S[stat["elsize"]]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def _csr(A):
    """The EllMatrix A (on the card) as a torch sparse CSR tensor: the
    library's sparse product, timed beside the ELL and DIA kernels."""
    n, w = A.vals.shape
    rows = torch.arange(n, device=A.vals.device).unsqueeze(1).expand(n, w)
    idx = torch.stack([rows[A.valid], A.cols[A.valid].long()])
    return torch.sparse_coo_tensor(idx, A.vals[A.valid], (n, A.total_nrow or n)).coalesce().to_sparse_csr()


def _conv_weight(op):
    """A u as one 3-D convolution: -1 at the stencil's neighbours, 27 at the
    centre (28 u - S(u), S including u)."""
    from hpccg_tpu_torch.operators import stencil_offsets

    w = torch.zeros((1, 1, 3, 3, 3), dtype=op.dtype, device="cuda")
    for sz, sy, sx in stencil_offsets(op.stencil):
        w[0, 0, sz + 1, sy + 1, sx + 1] = -1.0
    w[0, 0, 1, 1, 1] = 27.0
    return w


def _time_pair(stat, kern, plain) -> None:
    """Device ms per call of kern and plain (_graph_ms), timed plain,
    kernel, kernel, plain: the two versions share the card's state."""
    t_plain1, t_k1, t_k2, t_plain2 = (_graph_ms(f) for f in (plain, kern, kern, plain))
    stat["ms"] = (t_k1 + t_k2) / 2
    stat["plain_ms"] = (t_plain1 + t_plain2) / 2


def _counters():
    """kernel -> (wrapper, attribute) of its launch count. K14's class runs
    K11/K12's kernel: its rows read their counters, on the solves that
    gather the permuted twin in place."""
    from hpccg_tpu_torch.ops.cuda import collective as col
    from hpccg_tpu_torch.ops.cuda import dia as cdia
    from hpccg_tpu_torch.ops.cuda import ell as cell
    from hpccg_tpu_torch.ops.cuda import fused_cg as fc
    from hpccg_tpu_torch.ops.cuda import megakernel as mk
    from hpccg_tpu_torch.ops.cuda import stencil as st
    from hpccg_tpu_torch.ops.cuda import streamkernel as sk

    from hpccg_tpu_torch.ops.cuda import stream

    wrappers = [st.spmv_stencil, st.spmv_stencil_pap, st.update_p_apply, fc.update_x_r, fc.cg_finalize,
                mk.cg_solve_mega, sk.cg_solve_stream, st.spmv_stencil_pap_dd]
    counters = [(w, "launches") for w in wrappers]
    counters += [(cdia.spmv_dia, "launches_f32"), (cdia.spmv_dia, "launches_f64"),
                 (cell.spmv_ell, "launches_f32"), (cell.spmv_ell, "launches_f64"),
                 (cell.spmv_ell, "launches_scatter_f32"), (cell.spmv_ell, "launches_f32"),
                 (col.cg_collective, "launches"), (col.cg_collective_pipelined, "launches"),
                 (col.cg_collective_dia, "launches")]
    counters += [(w, "launches_bf16") for w in (st.spmv_stencil, st.spmv_stencil_pap, st.update_p_apply,
                                                fc.update_x_r)]
    counters += [(stream.copy_plus_one, "launches"), (stream.write_tiled, "launches")]
    counters += [(col.cg_collective, "launches_bf16"), (col.cg_collective_pipelined, "launches_bf16"),
                 (cdia.spmv_dia, "launches_bf16"), (cdia.spmv_dia, "launches_bf16_window"),
                 (cell.spmv_ell, "launches_bf16")]
    counters += [(st.update_p_apply, "launches"), (fc.update_x_r, "launches")]
    counters += [(mk.cg_solve_mega, "launches_f32"), (sk.cg_solve_stream, "launches_f32"),
                 (mk.cg_solve_mega, "launches_bf16"), (sk.cg_solve_stream, "launches_bf16")]
    # slice 10's rows are K15/K16 at 4 x 100^3: their own main path's count
    counters += [(col.cg_collective, "launches"), (col.cg_collective_pipelined, "launches")]
    # slice 11's row is K17's float64 instance, counted apart as well
    counters += [(col.cg_collective_dia, "launches_f64")]
    # slice 12's rows are K13's float64 instance and K14's (K12's)
    counters += [(cell.spmv_ell, "launches_scatter_f64"), (cell.spmv_ell, "launches_f64")]
    # K3 without the Ap' store (counted apart too) and K4s, at 300^3 float64
    counters += [(st.update_p_apply, "launches_noap"), (st.update_x_r_stencil, "launches")]
    return dict(zip(KERNELS, counters))


def _launch_sum(delta) -> int:
    """The launches in a count delta, each launch once (slice 10's rows
    read the counters of K15 and K16, slice 11's the float64 launches of
    K17, K14's rows K11's and K12's)."""
    return sum(d for n, d in delta.items() if n not in SLICE10 + SLICE11 + SHARED)


def _counts() -> dict:
    return {name: getattr(w, attr) for name, (w, attr) in _counters().items()}


def _launch_note(delta) -> str:
    return json.dumps({" ".join(n.split()[:2 if n in SLICE12 else 1]): d for n, d in delta.items()
                       if d and n not in SHARED})


def _trace_check(tr, ref, what, rtol=1e-4, floor=1e-7):
    """Trace against a reference trace (stencil's, or a plain version's):
    within rtol while the residual is above
    floor * trace[0], about float32's epsilon, where the true residual
    stagnates; below it the recurrence residual follows the rounding of
    each run (measured: two runs part by 1e-4 somewhere between 1e-8 and
    1e-11 of trace[0]) and only its order of magnitude is held, as in the
    golden run's log-tail check."""
    n = min(len(tr), len(ref))
    tr, ref = tr[:n], ref[:n]
    rel = (tr - ref).abs() / ref.abs()
    head = ref > floor * ref[0]
    worst = float(rel[head].max())
    if not worst <= rtol:
        k = int(torch.nonzero(head & (rel > rtol))[0])
        raise AssertionError(f"{what}: trace differs from the reference's by {worst:.3e} (first at k={k}, "
                             f"{float(tr[k])!r} vs {float(ref[k])!r})")
    decades = (tr[~head].log10() - ref[~head].log10()).abs()
    limit = 0.05 * ref[~head].log10().abs() + 1.0
    if bool((decades > limit).any()):
        raise AssertionError(f"{what}: trace tail off by {float(decades.max()):.2f} decades")
    tail = float(rel[~head].max()) if bool((~head).any()) else 0.0
    return worst, tail


def _solve_all(dims, max_iter, backends, dtype=torch.float32):
    """The main path through the user's entry points; returns traces and the
    launch counts of each backend's run."""
    from hpccg_tpu_torch import ProblemConfig, generate_problem, make_cg

    prob = generate_problem(ProblemConfig(*dims, stencil=27, dtype=dtype), device="cuda")
    out = {}
    for backend in backends:
        before = _counts()
        res = make_cg(prob.A, max_iter=max_iter, tolerance=0.0, backend=backend)(prob.b, prob.x0)
        torch.cuda.synchronize()
        niters, normr = int(res.niters), float(res.normr)
        delta = {n: c - before[n] for n, c in _counts().items()}
        if niters != max_iter - 1 or not math.isfinite(normr):
            raise AssertionError(f"{backend} {dims} {dtype}: niters {niters}, normr {normr}")
        if not bool(torch.isfinite(res.x).all()):
            raise AssertionError(f"{backend} {dims} {dtype}: non-finite x")
        out[backend] = (res.trace.double().cpu(), delta, res)
        say(f"[main] {dims} {str(dtype)[6:]} {backend}: niters {niters} normr {normr:.6e} "
            f"launches {_launch_note(delta)}")
    return out


def _drive(path, kernels) -> dict:
    """Run one main path with every launch count set to 0 just before it;
    returns the counts read just after, and fails unless each of the path's
    kernels was launched."""
    for w, attr in _counters().values():
        setattr(w, attr, 0)
    path()
    launches = _counts()
    for name in kernels:
        if launches[name] <= 0:
            raise AssertionError(f"{name} was not launched on its main path")
    return launches


def _main_path_slice1() -> None:
    names = list(KERNELS)
    runs = _solve_all(MAIN_SHAPE, 150, ["auto", "pallas", "stencil"])
    fused = runs["auto"][1]
    for n in (names[0], names[2], K4S, names[4]):
        if fused[n] <= 0:
            raise AssertionError(f"auto (pallas_fused) did not launch {n}")
    if fused[names[3]] or fused[K3N] != fused[names[2]]:
        raise AssertionError(f"auto (pallas_fused) on one device launched K4 or K3 with its Ap' store: {fused}")
    if runs["pallas"][1][names[1]] <= 0 or runs["pallas"][1][names[4]] <= 0:
        raise AssertionError("pallas did not launch K2 and finalize")
    if any(runs["stencil"][1].values()):
        raise AssertionError("the stencil backend launched a kernel")
    ref = runs["stencil"][0]
    for backend in ("auto", "pallas"):
        worst, tail = _trace_check(runs[backend][0], ref, f"{backend} 100^3")
        say(f"[main] 100^3 {backend}: trace within {worst:.2e} of stencil's above 1e-7 of "
            f"trace[0], {tail:.2e} below")
    again = _solve_all(MAIN_SHAPE, 150, ["pallas_fused"])["pallas_fused"][0]
    if not torch.equal(again, runs["auto"][0]):
        raise AssertionError("two pallas_fused solves gave different traces")
    say("[main] two pallas_fused solves: bit-identical traces")
    big = _solve_all((256, 256, 256), 50, ["auto", "pallas", "stencil"])
    for backend in ("auto", "pallas"):
        worst, tail = _trace_check(big[backend][0], big["stencil"][0], f"{backend} 256^3")
        say(f"[main] 256^3 {backend}: trace within {worst:.2e} of stencil's above 1e-7 of "
            f"trace[0], {tail:.2e} below")


# bf16 whole solves against the float32 stencil trace, a check of bf16's
# accuracy (the kernels are held to their bf16 plain versions by
# _against_plain): within BF16_RTOL while the residual stays above
# BF16_FLOOR * trace[0]. bf16 keeps 8 significant bits, and its recurrence
# drifts from f32's as it goes. The runs are deterministic; the readings at
# 256^3 are K5 4.46e-2 and K6 7.58e-3 (PERF.md, Findings: the limit was set
# after a reading of 2.77e-2 failed a tighter one).
BF16_RTOL, BF16_FLOOR = 5e-2, 1e-3


def _one_whole_launch(runs, what) -> None:
    """One launch of K5 (megakernel) or K6 (streamkernel) per solve, and no
    launch of another wrapper (the 256^3 and bf16 rows count on K5's and
    K6's wrappers too)."""
    counters = _counters()
    for backend, name in (("megakernel", K5), ("streamkernel", K6)):
        if backend not in runs:
            continue
        delta = runs[backend][1]
        others = [n for n, d in delta.items() if d and counters[n][0] is not counters[name][0]]
        if delta[name] != 1 or others:
            raise AssertionError(f"{what} {backend}: expected one whole-solve launch, got {delta}")


MAIN_X_ERR = {}  # (dtype, backend) -> max|x - x_plain| of the main path's 256^3 whole solves


def _against_plain(runs, dims, max_iter, dtype) -> None:
    """The main path's whole solves against their plain versions on the same
    problem: niters equal, the trace within WS_TRACE above its floor (its
    order of magnitude below), x as _x_check holds it (recorded in
    MAIN_X_ERR)."""
    from hpccg_tpu_torch import ProblemConfig, generate_problem
    from hpccg_tpu_torch.ops.cuda import megakernel as mk
    from hpccg_tpu_torch.ops.cuda import streamkernel as sk

    prob = generate_problem(ProblemConfig(*dims, stencil=27, dtype=dtype), device="cuda")
    rtol, floor = WS_TRACE[dtype]
    for backend, plain in (("megakernel", mk.cg_solve_mega_plain), ("streamkernel", sk.cg_solve_stream_plain)):
        res = runs[backend][2]
        want = plain(prob.A, prob.b, prob.x0, max_iter=max_iter)
        what = f"{dims} {str(dtype)[6:]} {backend} vs its plain version"
        if int(res.niters) != int(want.niters):
            raise AssertionError(f"{what}: niters {int(res.niters)} vs {int(want.niters)}")
        worst, tail = _trace_check(res.trace.double().cpu(), want.trace.double().cpu(), what, rtol, floor)
        xerr = MAIN_X_ERR[(dtype, backend)] = _x_check(res.x, want.x, what)
        ulp = _ulp_note(res.x, want.x)
        say(f"[main] {what}: niters equal, trace within {worst:.2e} above {floor} of trace[0], "
            f"{tail:.2e} below; max|x - x_plain| {xerr:.2e}{ulp}")


def _main_path_slice2() -> None:
    runs = _solve_all(MAIN_SHAPE, 150, ["megakernel", "streamkernel", "pallas_v1", "stencil"])
    _one_whole_launch(runs, "100^3")
    v1 = runs["pallas_v1"][1]
    if v1[list(KERNELS)[0]] <= 0 or v1[list(KERNELS)[1]] != 0:
        raise AssertionError(f"pallas_v1 should run K1 and not K2: {v1}")
    for backend in ("megakernel", "streamkernel", "pallas_v1"):
        worst, tail = _trace_check(runs[backend][0], runs["stencil"][0], f"{backend} 100^3")
        say(f"[main] 100^3 {backend}: trace within {worst:.2e} of stencil's above 1e-7 of "
            f"trace[0], {tail:.2e} below")
    big = _solve_all((256, 256, 256), 50, ["megakernel", "streamkernel", "stencil"])
    _one_whole_launch(big, "256^3")
    for backend in ("megakernel", "streamkernel"):
        worst, tail = _trace_check(big[backend][0], big["stencil"][0], f"{backend} 256^3")
        say(f"[main] 256^3 {backend}: trace within {worst:.2e} of stencil's above 1e-7 of "
            f"trace[0], {tail:.2e} below")
    _against_plain(big, (256, 256, 256), 50, torch.float32)
    bf = _solve_all((256, 256, 256), 50, ["megakernel", "streamkernel"], torch.bfloat16)
    _one_whole_launch(bf, "256^3 bf16")
    _against_plain(bf, (256, 256, 256), 50, torch.bfloat16)
    ref = big["stencil"][0]
    head = ref > BF16_FLOOR * ref[0]
    for backend, (tr, _, res) in bf.items():
        if res.x.dtype != torch.bfloat16 or res.trace.dtype != torch.float32 or res.niters.dtype != torch.int32:
            raise AssertionError(f"bf16 {backend}: x {res.x.dtype}, trace {res.trace.dtype}, niters {res.niters.dtype}")
        rel = ((tr - ref).abs() / ref)[head]
        if not float(rel.max()) <= BF16_RTOL:
            raise AssertionError(f"256^3 bf16 {backend}: trace {float(rel.max()):.3e} from float32's above "
                                 f"{BF16_FLOOR} of trace[0] (per iteration: {rel.tolist()})")
        say(f"[main] 256^3 bf16 {backend}: trace within {float(rel.max()):.2e} of the float32 stencil trace "
            f"over its first {int(head.sum())} entries (above {BF16_FLOOR} of trace[0]); "
            f"max|x - 1| {float((res.x.float() - 1).abs().max()):.3e}")
    long = _solve_all(MAIN_SHAPE, 300, ["megakernel"], torch.bfloat16)  # checks niters 299
    _one_whole_launch(long, "100^3 bf16 300")
    say("[main] 100^3 bf16 megakernel, max_iter 300: niters 299 (int32, exact past bf16's 256)")
    dd = _solve_all(MAIN_SHAPE, 150, ["pallas_dd", "stencil"], torch.float64)
    if dd["pallas_dd"][1][K7] <= 0 or dd["pallas_dd"][1][list(KERNELS)[1]] != 0:
        raise AssertionError(f"pallas_dd should run K7 and not K2: {dd['pallas_dd'][1]}")
    worst, tail = _trace_check(dd["pallas_dd"][0], dd["stencil"][0], "pallas_dd 100^3 f64", rtol=1e-10, floor=1e-11)
    say(f"[main] 100^3 f64 pallas_dd: trace within {worst:.2e} of stencil's above 1e-11 of trace[0], "
        f"{tail:.2e} below")


# ------------------------------------------------------------ slice 3: explicit matrices

EXPLICIT_SHAPE = (128, 128, 128)  # the slice's main path: 2,097,152 rows, 55,742,968 nonzeros
EXPLICIT_ITERS = 50
# explicit solve against the stencil backend on the same grid: (trace rtol,
# floor) as _trace_check takes them, and x within X_RTOL of max|x|
EXPLICIT_TRACE = {torch.float64: (1e-10, 1e-11), torch.float32: (1e-4, 1e-7)}
EXPLICIT_X_RTOL = {torch.float64: 1e-10, torch.float32: 1e-4}
SPARSE_DTYPES = (torch.float32, torch.float64)


def _stencil_ell(dims, dtype, device="cuda"):
    from hpccg_tpu_torch import ProblemConfig
    from hpccg_tpu_torch.models.stencil import generate_ell

    return generate_ell(ProblemConfig(*dims, dtype=dtype), device)


@functools.cache
def _explicit_128(dtype):
    """generate_ell(128^3) on the card and its DIA, built once per dtype."""
    prob = _stencil_ell(EXPLICIT_SHAPE, dtype)
    if (prob.total_nrow, prob.A.nnz) != (2_097_152, 55_742_968):
        raise AssertionError(f"128^3: {prob.total_nrow} rows, {prob.A.nnz} nonzeros")
    return prob, prob.A.to_dia()


def _cast(A, dtype, device="cuda"):
    """EllMatrix A with its values in ``dtype``, on ``device``."""
    return dataclasses.replace(A, vals=A.vals.to(dtype)).to(device)


def _permuted(prob, seed):
    """The problem with rows and columns randomly permuted (b and xexact
    with them), on the host: a wide scatter whose band RCM recovers. Returns
    (problem, perm): row i of the result is row perm[i] of ``prob``."""
    import numpy as np

    from hpccg_tpu_torch.reorder import permute_ell

    perm = np.random.default_rng(seed).permutation(prob.total_nrow)
    index = torch.from_numpy(perm)
    A = permute_ell(prob.A.to("cpu"), perm)
    return dataclasses.replace(prob, A=A, b=prob.b.cpu()[index], xexact=prob.xexact.cpu()[index]), perm


@functools.cache
def _permuted_128():
    """The randomly permuted 128^3 float32 stencil on the host, and what
    auto_structure makes of it: (twin, perm0, op, perm, report)."""
    from hpccg_tpu_torch.reorder import auto_structure

    t0 = time.perf_counter()
    twin, perm0 = _permuted(_stencil_ell(EXPLICIT_SHAPE, torch.float32, "cpu"), 7)
    t1 = time.perf_counter()
    op, perm, report = auto_structure(twin.A)
    say(f"[main] permuted 128^3 f32: {report.format} — {report.reason} (permuting {t1 - t0:.1f} s, "
        f"auto_structure {time.perf_counter() - t1:.1f} s on the host)")
    return twin, perm0, op, perm, report


@functools.cache
def _permuted_128_on_card(dtype):
    """The permuted 128^3 twin as loaded, on the card in ``dtype``. Every
    dtype shares the float32 twin's column and validity tensors, so the
    host's reverse Cuthill-McKee order of the relabelled layout is
    computed once (``reorder._rcm_cached`` keeps it per column tensor)."""
    twin = _permuted_128()[0]
    A = twin.A.to("cuda") if dtype == torch.float32 else _permuted_128_on_card(torch.float32)
    return dataclasses.replace(A, vals=A.vals.to(dtype))


def _random_band(n, ndiag, span, dtype, gen):
    """A random DIA band on the card: ndiag distinct offsets in [-span,
    span], 0 among them, zeros outside each diagonal."""
    from hpccg_tpu_torch.operators import DiaMatrix

    cand = (torch.randperm(2 * span + 1, generator=gen, device="cuda") - span).tolist()
    offs = sorted([0] + [o for o in cand if o != 0][: ndiag - 1])
    data = torch.randn((ndiag, n), generator=gen, device="cuda", dtype=dtype)
    for d, off in enumerate(offs):
        data[d, : max(0, -off)] = 0
        data[d, min(n, n - off):] = 0
    return DiaMatrix(data=data, offsets=tuple(offs), total_nrow=n)


def _wide_scatter(n, per_row, bw, dtype, gen):
    """A random wide scatter on the card (the class of the JAX package's
    strip-stack and dynamic-window tiers, tests/test_gell_stack.py): a
    dominant diagonal slot, per_row - 1 columns within +-bw, 15% invalid."""
    from hpccg_tpu_torch.operators import EllMatrix

    rows = torch.arange(n, device="cuda")[:, None]
    cols = (rows + torch.randint(-bw, bw + 1, (n, per_row), generator=gen, device="cuda")).clamp_(0, n - 1)
    cols[:, 0] = rows[:, 0]
    vals = torch.rand((n, per_row), generator=gen, device="cuda", dtype=dtype) * 0.9 - 1.0
    vals[:, 0] = per_row + 1.0
    valid = torch.rand((n, per_row), generator=gen, device="cuda") >= 0.15
    valid[:, 0] = True
    return EllMatrix(vals=torch.where(valid, vals, 0), cols=torch.where(valid, cols, 0).to(torch.int32),
                     valid=valid, start_row=0, total_nrow=n)


def _skewed(A, width=240):
    """EllMatrix A (on the card) padded to ``width`` slots, with row 5 using
    all of them: every row streams ``width`` slots."""
    n = A.local_nrow
    vals = torch.zeros((n, width), dtype=A.dtype, device="cuda")
    cols = torch.zeros((n, width), dtype=torch.int32, device="cuda")
    valid = torch.zeros((n, width), dtype=torch.bool, device="cuda")
    vals[:, : A.width], cols[:, : A.width], valid[:, : A.width] = A.vals, A.cols, A.valid
    vals[5], cols[5], valid[5] = 0.01, (torch.arange(width, device="cuda") * (n // width)).to(torch.int32), True
    return dataclasses.replace(A, vals=vals, cols=cols, valid=valid)


def _sparse_pair(kern, plain, dtype, what, exact) -> float:
    """Kernel against plain on the same inputs: within VEC_RTOL (bit for bit
    where ``exact``), and two launches bit-identical."""
    got, again = kern(), kern()
    want = plain()
    torch.cuda.synchronize()
    err = _vec_err(got, want, dtype, what)
    if exact and not torch.equal(_bits(got), _bits(want)):
        raise AssertionError(f"{what}: the kernel differs from its plain version (max {err:.3e})")
    if not torch.equal(_bits(got), _bits(again)):
        raise AssertionError(f"{what}: two launches differ")
    return err


def _gbs(nbytes, ms) -> float:
    return nbytes / (ms * 1e-3) / 1e9


def _dia_bytes(D) -> int:
    """The DIA byte model: ndiag*n*s of data, x and y."""
    return (D.ndiag + 2) * D.local_nrow * D.data.element_size()


def _ell_bytes(S) -> int:
    """The ELL byte model (S an EllMatrix or its slot-major layout):
    width*n*(s + 4) of values and columns, x and y."""
    s = S.vals.element_size()
    return S.width * S.local_nrow * (s + 4) + 2 * S.local_nrow * s


def phase_sparse_kernels(card: str) -> dict:
    """K9-K12 against their plain versions, float32 and float64: the DIA of
    the 27-point stencil at 100^3 and 128^3 and a random 1000-diagonal band
    at n = 1,000,003; the ELL of the stencil at 100^3 and 128^3, the randomly
    permuted 64^3 stencil as loaded (the wide-scatter class of K13) and
    after RCM, a random wide scatter (n = 10^6, 9 slots within +-3*10^5: the
    class of K14), and a skewed matrix (one row of 240 slots). DIA must match
    bit for bit (same sums, same roundings), ELL within VEC_RTOL; two launches
    bit-identical. The chooser (``prepare_ell``) must take the relabelled
    layout on K13's class and K11/K12's on the others, K14's class
    included; there K13's kernel is held against its plain version within
    VEC_RTOL, and bit for bit against K11/K12's launch on the same matrix
    and its own second launch. Device time per
    launch (_time_pair), kernel and plain in turns, with effective GB/s
    under the byte models of _dia_bytes and _ell_bytes. The kernels line
    takes K9-K12's times at 128^3 and K13's / K14's on their classes, in
    float32 and (slice 12's rows) float64."""
    from hpccg_tpu_torch.ops.cuda import dia as cdia
    from hpccg_tpu_torch.ops.cuda import ell as cell
    from hpccg_tpu_torch.reorder import permute_ell, rcm_permutation

    stats = {name: {"max_abs_err": 0.0} for name in SLICE3 + SLICE12}
    gen = torch.Generator(device="cuda").manual_seed(2024)
    perm64, _ = _permuted(_stencil_ell((64, 64, 64), torch.float64, "cpu"), 1)
    rcm64 = permute_ell(perm64.A, rcm_permutation(perm64.A))
    for dtype in SPARSE_DTYPES:
        f32 = dtype == torch.float32
        k_dia, k_ell = (K9, K11) if f32 else (K10, K12)
        dia_cases = [("100^3 stencil", _stencil_ell((100,) * 3, dtype).A.to_dia()),
                     ("128^3 stencil", _explicit_128(dtype)[1]),
                     ("1000-diagonal band n=1000003", _random_band(1_000_003, 1000, 4000, dtype, gen))]
        for tag, D in dia_cases:
            P = cdia.prepare_dia(D)
            x = torch.randn(D.local_nrow, generator=gen, device="cuda", dtype=dtype)
            out = torch.empty_like(x)
            what = f"{k_dia.split()[0]} {tag} {str(dtype)[6:]}"
            err = _sparse_pair(lambda: cdia.spmv_dia(P, x), lambda: cdia.spmv_dia_plain(P, x), dtype, what, True)
            stats[k_dia]["max_abs_err"] = max(stats[k_dia]["max_abs_err"], err)
            timed = tag.startswith("128")
            st = stats[k_dia] if timed else {}
            _time_pair(st, lambda: cdia.spmv_dia(P, x, out=out), lambda: cdia.spmv_dia_plain(P, x, out=out))
            nbytes = _dia_bytes(D)
            if timed:  # the 128^3 cell: its CSR (from the ELL of the same matrix) is the library's product
                csr = _csr(_explicit_128(dtype)[0].A)
                _model(st, nbytes, 2 * csr.values().numel(), D.data.element_size())
                st["library_ms"] = _event_ms(lambda: torch.mv(csr, x))
                del csr
            say(f"[sparse] {what}: ok, bit for bit; {D.ndiag} diagonals; {st['ms'] * 1e3:.1f} us vs plain "
                f"{st['plain_ms'] * 1e3:.1f} ({_gbs(nbytes, st['ms']):.0f} vs {_gbs(nbytes, st['plain_ms']):.0f} "
                f"GB/s) [{card}]")
        ell_cases = [("100^3 stencil", k_ell, _stencil_ell((100,) * 3, dtype).A),
                     ("128^3 stencil", k_ell, _explicit_128(dtype)[0].A),
                     ("permuted 64^3 stencil as loaded", K13, _cast(perm64.A, dtype)),
                     ("permuted 64^3 stencil after RCM", k_ell, _cast(rcm64, dtype)),
                     ("wide scatter n=10^6", K14, _wide_scatter(1_000_000, 9, 300_000, dtype, gen)),
                     ("skewed 100^3 (one row of 240 slots)", k_ell, _skewed(_stencil_ell((100,) * 3, dtype).A))]
        for tag, name, A in ell_cases:
            if name in WIDE and not f32:
                name = K13D if name == K13 else K14D
            S = cell.prepare_ell(A)
            if isinstance(S, cell.ScatterEll) != (name in WIDE13):
                raise AssertionError(f"{tag} {dtype}: the chooser took {type(S).__name__}")
            x = torch.randn(A.local_nrow, generator=gen, device="cuda", dtype=dtype)
            out = torch.empty_like(x)
            what = f"{name.split()[0]} {tag} {str(dtype)[6:]}"
            err = _sparse_pair(lambda: cell.spmv_ell(S, x), lambda: cell.spmv_ell_plain(S, x), dtype, what, False)
            note = ""
            if name in WIDE13:  # the relabelled form gives K11/K12's bits on the same matrix
                E = cell.ell_slots(A)
                first = cell.spmv_ell(E, x)
                y, again = cell.spmv_ell(S, x), cell.spmv_ell(S, x)
                torch.cuda.synchronize()
                if not (torch.equal(_bits(y), _bits(first)) and torch.equal(_bits(y), _bits(again))):
                    raise AssertionError(f"{what}: the relabelled form differs from {k_ell.split()[0]}'s launch "
                                         "or from its own second launch")
                note = (f"; bit for bit {k_ell.split()[0]}'s, which takes "
                        f"{_graph_ms(lambda: cell.spmv_ell(E, x, out=out)) * 1e3:.1f} us")
            for key in {name, k_ell}:
                stats[key]["max_abs_err"] = max(stats[key]["max_abs_err"], err)
            timed = tag.startswith("128") or name in WIDE
            st = stats[name] if timed else {}
            _time_pair(st, lambda: cell.spmv_ell(S, x, out=out), lambda: cell.spmv_ell_plain(S, x, out=out))
            nbytes = _ell_bytes(S)
            if timed:
                csr = _csr(A.to("cuda"))
                _model(st, nbytes, 2 * csr.values().numel(), A.vals.element_size())
                st["library_ms"] = _event_ms(lambda: torch.mv(csr, x))
                del csr
            say(f"[sparse] {what}: ok, max err {err:.2e}; width {S.width}; {st['ms'] * 1e3:.1f} us vs plain "
                f"{st['plain_ms'] * 1e3:.1f} ({_gbs(nbytes, st['ms']):.0f} vs {_gbs(nbytes, st['plain_ms']):.0f} "
                f"GB/s){note} [{card}]")
    return stats


def _explicit_solve(A, b, x0, what):
    """One explicit-matrix solve through make_cg on ``auto``; prints its
    launches."""
    from hpccg_tpu_torch import make_cg

    before = _counts()
    res = make_cg(A, max_iter=EXPLICIT_ITERS, tolerance=0.0)(b, x0)
    torch.cuda.synchronize()
    delta = {n: c - before[n] for n, c in _counts().items()}
    if int(res.niters) != EXPLICIT_ITERS - 1 or not math.isfinite(float(res.normr)):
        raise AssertionError(f"{what}: niters {int(res.niters)}, normr {float(res.normr)}")
    if not bool(torch.isfinite(res.x).all()):
        raise AssertionError(f"{what}: non-finite x")
    say(f"[main] {what}: niters {int(res.niters)} normr {float(res.normr):.6e} launches {_launch_note(delta)}")
    return res, delta


def _stencil_reference(dtype):
    """The stencil backend (plain torch) on the StencilOperator of the 128^3
    grid: what the explicit solves are held against."""
    from hpccg_tpu_torch import ProblemConfig, generate_problem, make_cg

    sprob = generate_problem(ProblemConfig(*EXPLICIT_SHAPE, dtype=dtype), device="cuda")
    return make_cg(sprob.A, max_iter=EXPLICIT_ITERS, tolerance=0.0, backend="stencil")(sprob.b, sprob.x0)


def _against_stencil(res, ref, dtype, what) -> None:
    rtol, floor = EXPLICIT_TRACE[dtype]
    worst, tail = _trace_check(res.trace.double().cpu(), ref.trace.double().cpu(), what, rtol, floor)
    xerr = float((res.x.double() - ref.x.double()).abs().max())
    if not xerr <= EXPLICIT_X_RTOL[dtype] * float(ref.x.double().abs().max()):
        raise AssertionError(f"{what}: max|x - x_stencil| = {xerr:.3e}")
    say(f"[main] {what}: trace within {worst:.2e} of the stencil backend's above {floor} of trace[0], "
        f"{tail:.2e} below; max|x - x_stencil| {xerr:.2e}")


def _main_path_slice3() -> None:
    """make_cg on generate_ell(128^3) as ELL and as DIA, float64 and float32,
    on auto (the matrix's kernel), each against the stencil backend on the
    StencilOperator of the same grid."""
    for dtype in (torch.float64, torch.float32):
        prob, dia = _explicit_128(dtype)
        ref = _stencil_reference(dtype)
        f32 = dtype == torch.float32
        for fmt, A, kernel in (("ELL", prob.A, K11 if f32 else K12), ("DIA", dia, K9 if f32 else K10)):
            what = f"128^3 {str(dtype)[6:]} {fmt} auto"
            res, delta = _explicit_solve(A, prob.b, prob.x0, what)
            if delta[kernel] < EXPLICIT_ITERS:  # the initial Ap and one per iteration
                raise AssertionError(f"{what}: {kernel} launched {delta[kernel]} times")
            _against_stencil(res, ref, dtype, what)


def _window_us(A, b, x0) -> float:
    """us per iteration of one EXPLICIT_ITERS-iteration solve on auto, CUDA
    events around the solve alone (its layout built before)."""
    from hpccg_tpu_torch import make_cg

    solve = make_cg(A, max_iter=EXPLICIT_ITERS, tolerance=0.0)
    solve(b, x0)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    solve(b, x0)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) * 1e3 / EXPLICIT_ITERS


def _main_path_wide_scatter() -> None:
    """The randomly permuted 128^3 stencil, the wide-scatter class of K13:
    in float32 through auto_structure (ell+rcm) and solved in its basis,
    then solved as loaded (K13's kernel, relabelled) in float32 and
    float64; x in the permuted problem's order against the stencil solve's.
    Prints each solve's us per iteration (a CUDA-event window around one
    solve)."""
    twin, perm0, op, perm, report = _permuted_128()
    if report.format != "ell+rcm":
        raise AssertionError(f"permuted 128^3: expected ell+rcm, got {report.format}")
    ref = _stencil_reference(torch.float32)
    ref = dataclasses.replace(ref, x=ref.x[torch.from_numpy(perm0).cuda()])  # in the twin's order
    index = torch.from_numpy(perm).cuda()
    b, x0 = twin.b.cuda(), twin.x0.cuda()
    rcm = op.to("cuda")
    res, _ = _explicit_solve(rcm, b[index], x0[index], "permuted 128^3 f32 ell+rcm auto")
    x = torch.empty_like(res.x)
    x[index] = res.x  # the solve basis back to the twin's order
    _against_stencil(dataclasses.replace(res, x=x), ref, torch.float32, "permuted 128^3 f32 ell+rcm")
    window = {"ell+rcm": _window_us(rcm, b[index], x0[index])}
    for dtype in SPARSE_DTYPES:
        A = _permuted_128_on_card(dtype)
        bd, x0d = b.to(dtype), x0.to(dtype)
        what = f"permuted 128^3 {str(dtype)[6:]} ELL as loaded"
        t0 = time.perf_counter()
        res, delta = _explicit_solve(A, bd, x0d, f"{what} auto")
        kernel = K13 if dtype == torch.float32 else K13D
        if delta[kernel] < EXPLICIT_ITERS:  # the initial Ap and one per iteration
            raise AssertionError(f"{what}: {kernel} launched {delta[kernel]} times")
        say(f"[main] {what}: the solve with its layout (the relabel rule's pre-test on the card, RCM on the host "
            f"once per matrix) took {time.perf_counter() - t0:.1f} s")
        if dtype == torch.float32:
            _against_stencil(res, ref, dtype, what)
        else:
            sref = _stencil_reference(dtype)
            _against_stencil(res, dataclasses.replace(sref, x=sref.x[torch.from_numpy(perm0).cuda()]), dtype,
                             what)
        window[f"as loaded {str(dtype)[6:]}"] = _window_us(A, bd, x0d)
    say("[main] permuted 128^3 solves, us/iter (CUDA-event window around one 50-iteration solve): "
        + ", ".join(f"{k} {v:.2f}" for k, v in window.items()))


def _main_path_wide_inplace() -> None:
    """The permuted 128^3 twin as loaded on the ell-allgather tier at
    FILE_NDEV ranks of the card, float32 and float64: each rank's rows
    gather from the whole of x, in place, on K11/K12 (K14's kernel; a
    rank's block is never relabelled); x in the twin's order against the
    stencil solve's."""
    mesh = _one_card(FILE_NDEV)
    twin, perm0 = _permuted_128()[:2]
    order = torch.from_numpy(perm0).cuda()
    for dtype in SPARSE_DTYPES:
        what = f"permuted 128^3 {str(dtype)[6:]} as loaded, {FILE_NDEV} x ell-allgather"
        kernel = K14 if dtype == torch.float32 else K14D
        sp = _sharded_file_problem(_permuted_128_on_card(dtype), mesh, twin.b.to("cuda", dtype))
        before = _counts()
        res = _file_tier("ell-allgather")(mesh, max_iter=EXPLICIT_ITERS)(sp.A, sp.b, sp.x0)
        torch.cuda.synchronize()
        delta = {n: c - before[n] for n, c in _counts().items()}
        if delta[kernel] != FILE_NDEV * EXPLICIT_ITERS or delta[K13] or delta[K13D]:
            raise AssertionError(f"{what}: launches {delta}")
        ref = _stencil_reference(dtype)
        res = dataclasses.replace(res, x=torch.cat(res.x)[: twin.total_nrow])
        _against_stencil(res, dataclasses.replace(ref, x=ref.x[order]), dtype, what)
        say(f"[main] {what}: niters {int(res.niters)} normr {float(res.normr):.6e}; launches {_launch_note(delta)}")


def phase_main_path() -> dict:
    """Slice 1's main path, slice 2's, slice 3's and its wide-scatter solves
    (as loaded on one device, K13, and in place on the ell-allgather tier,
    K14), slice 4's distributed solves, slice 5's distributed file-mode
    solves, slice 6's bf16 K1-K4 path and slice 7's bf16 collective and
    file-mode solves, slice 8's 256^3 float32 pallas_fused solve and slice
    10's 4 x 100^3 collective solves, each with its own counts; the launches
    reported for each kernel are those of its own run. Slice 9's kernels
    (K5/K6 at 256^3, float32 and bfloat16) run on slice 2's path and are
    read from its counts, slice 11's (K17 in float64) on slice 5's. K3 with
    its Ap' store and K4 run only on the distributed pallas_fused path:
    their rows are read from slice 4's distributed solves (K3, K4),
    a distributed bf16 solve of slice 6 (K3/K4 bf16) and one of slice 8
    (K3/K4 256^3), each driven alone; K3 without its Ap' store and K4s from
    slice 16's 300^3 float64 solve, whose K3 + K4 comparison is solved
    outside its drive."""
    one = [n for n in SLICE1 if n not in (SLICE1[2], K4)]  # K3 and K4 are counted on slice 4's path
    first = _drive(_main_path_slice1, one + [SLICE1[2], K3N, K4S])
    second = _drive(_main_path_slice2, SLICE2 + SLICE9)
    third = _drive(_main_path_slice3, [K9, K10, K11, K12])
    wide = _drive(_main_path_wide_scatter, WIDE13)
    inplace = _drive(_main_path_wide_inplace, WIDE14)
    fourth = _drive(_main_path_slice4, SLICE4 + [SLICE1[2], K4])
    fifth = _drive(_main_path_slice5, SLICE5 + SLICE11)
    sixth = _drive(_main_path_slice6, [n for n in SLICE6 if n != B4])
    ref6 = _bf16_fused_reference()
    sixth_fused = _drive(lambda: _main_path_slice6_fused(ref6), [B3, B4])
    seventh = _drive(_main_path_slice7, SLICE7)
    eighth = _drive(_main_path_slice8, [BIG3, K3N, K4S])
    eighth_fused = _drive(_main_path_slice8_fused, SLICE8)
    tenth = _drive(_main_path_slice10, SLICE10)
    route = _k3_k4_route()
    sixteenth = _drive(lambda: _main_path_slice16(route), SLICE16)
    runs = [(one, first), (SLICE2, second), ([K9, K10, K11, K12], third), (WIDE13, wide), (WIDE14, inplace),
            (SLICE4 + [SLICE1[2], K4], fourth), (SLICE5, fifth), ([n for n in SLICE6 if n not in (B3, B4)], sixth),
            ([B3, B4], sixth_fused), (SLICE7, seventh), (SLICE8, eighth_fused), (SLICE9, second),
            (SLICE10, tenth), (SLICE11, fifth), (SLICE16, sixteenth)]
    return {n: counts[n] for names, counts in runs for n in names}


GOLDEN = {0: 258.24, 15: 2.15402e-06, 30: 2.81972e-20, 45: 6.66682e-30, 60: 7.96609e-39,
          75: 1.85259e-48, 90: 1.15032e-56, 105: 1.01621e-65, 120: 1.39759e-75,
          135: 1.07273e-83, 149: 1.68304e-92}  # the reference's out.txt, 10^3


def _check_golden(trace, niters, what) -> None:
    """149 iterations and the golden trace: trace[0] and trace[15] to 6
    digits, the rest to their order of magnitude."""
    if niters != 149:
        raise AssertionError(f"golden {what}: niters {niters}")
    if abs(trace[0] - GOLDEN[0]) > 1e-5 * GOLDEN[0] or abs(trace[15] - GOLDEN[15]) > 1e-4 * GOLDEN[15]:
        raise AssertionError(f"golden {what}: trace[0] {trace[0]!r}, trace[15] {trace[15]!r}")
    for k, ref in GOLDEN.items():
        if k > 15 and not abs(math.log10(trace[k]) - math.log10(ref)) < 0.05 * abs(math.log10(ref)) + 1.0:
            raise AssertionError(f"golden {what}: trace[{k}] {trace[k]!r} vs {ref!r}")
    say(f"[golden] 10^3 float64 {what}: niters 149, trace[0] {trace[0]:.6g}, "
        f"trace[15] {trace[15]:.6g}, trace[149] {trace[149]:.6g}")


def _cli(args, what) -> tuple:
    """main(args) with its output captured; fails unless it returns 0.
    Returns (the JSON report, the residual lines as {k: residual}, stderr)."""
    from hpccg_tpu_torch.cli import main

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(args)
    if rc != 0:
        raise AssertionError(f"cli {what} returned {rc}: {err.getvalue()[-2000:]}")
    text = out.getvalue()
    trace = {0: float(text.split("Initial Residual = ")[1].split()[0])}
    for line in text.splitlines():
        if line.startswith("Iteration = "):  # "Iteration = k   Residual = r"
            parts = line.split()
            trace[int(parts[2])] = float(parts[5])
    return json.loads(text[text.index("\n{") + 1 :]), trace, err.getvalue()


def _structure_line(err: str) -> str:
    return next(line for line in err.splitlines() if line.startswith("# matrix structure: "))


def phase_golden() -> None:
    """The golden run on four stencil backends, from a 10^3 float64 file
    through the CLI (DIA, K10), and through make_cg on generate_ell's
    EllMatrix (ELL, K12)."""
    from hpccg_tpu_torch import ProblemConfig, generate_problem, make_cg
    from hpccg_tpu_torch.io import write_hpc_row
    from hpccg_tpu_torch.ops.cuda import dia as cdia
    from hpccg_tpu_torch.ops.cuda import ell as cell

    prob = generate_problem(ProblemConfig(10, 10, 10, dtype=torch.float64), device="cuda")
    for backend in ("pallas_fused", "megakernel", "streamkernel", "pallas_dd"):
        res = make_cg(prob.A, max_iter=150, tolerance=0.0, backend=backend)(prob.b, prob.x0)
        _check_golden(res.trace.cpu().numpy(), int(res.niters), backend)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "golden10.txt")
        write_hpc_row(path, _stencil_ell((10, 10, 10), torch.float64, "cpu"))
        before = cdia.spmv_dia.launches_f64
        report, trace, err = _cli([path, "--json"], "golden file")
        if not _structure_line(err).startswith("# matrix structure: dia —") or cdia.spmv_dia.launches_f64 == before:
            raise AssertionError(f"golden file: not solved on K10 ({_structure_line(err)})")
        _check_golden(trace, report["Number of iterations"], "file through the CLI (DIA, K10)")
    ell = _stencil_ell((10, 10, 10), torch.float64)
    before = cell.spmv_ell.launches_f64
    res = make_cg(ell.A, max_iter=150, tolerance=0.0, backend="ell")(ell.b, ell.x0)
    if cell.spmv_ell.launches_f64 - before < 150:
        raise AssertionError("golden make_cg(EllMatrix): K12 was not launched once per matvec")
    _check_golden(res.trace.cpu().numpy(), int(res.niters), "make_cg on the EllMatrix (ELL, K12)")


def phase_cli() -> None:
    for extra in (["--dtype", "float32"], ["--backend", "megakernel", "--dtype", "float32"],
                  ["--dtype", "bfloat16"]):
        report, _, _ = _cli(["100", "100", "100", "--json", *extra], " ".join(extra))
        if report["Number of iterations"] != 149:
            raise AssertionError(f"cli {' '.join(extra)}: {report['Number of iterations']} iterations")
        say(f"[cli] {' '.join(extra)}: rc 0, iterations 149, "
            f"time summary {json.dumps(report['Time Summary'])}")


def phase_cli_files() -> None:
    """File mode at 64^3: the 27-point float64 file and its randomly
    permuted twin (262,144 rows, 6,859,000 nonzeros), written by the port's
    writer; the CLI solves the first as DIA and the twin as ell+rcm, or as
    ELL with --no-reorder, 149 iterations each."""
    from hpccg_tpu_torch.io import read_hpc_row, write_hpc_row

    prob = _stencil_ell((64, 64, 64), torch.float64, "cpu")
    if (prob.total_nrow, prob.A.nnz) != (262_144, 6_859_000):
        raise AssertionError(f"64^3: {prob.total_nrow} rows, {prob.A.nnz} nonzeros")
    with tempfile.TemporaryDirectory() as tmp:
        paths = {}
        for name, p in (("stencil", prob), ("permuted", _permuted(prob, 3)[0])):
            paths[name] = os.path.join(tmp, f"{name}64.txt")
            t0 = time.perf_counter()
            write_hpc_row(paths[name], p)
            t1 = time.perf_counter()
            read_hpc_row(paths[name], to_dia=False)
            say(f"[cli] 64^3 {name} file: {os.path.getsize(paths[name]) / 1e6:.1f} MB, write {t1 - t0:.2f} s, "
                f"read {time.perf_counter() - t1:.2f} s (host)")
        for name, extra, want in (("stencil", [], "dia"), ("permuted", [], "ell+rcm"),
                                  ("permuted", ["--no-reorder"], "ell")):
            what = f"64^3 {name} file {' '.join(extra)}".strip()
            t0 = time.perf_counter()
            report, _, err = _cli([paths[name], "--json", *extra], what)
            line = _structure_line(err)
            if report["Number of iterations"] != 149 or not line.startswith(f"# matrix structure: {want} —"):
                raise AssertionError(f"cli {what}: {report['Number of iterations']} iterations; {line}")
            say(f"[cli] {what}: rc 0, iterations 149, {line[2:]}; {time.perf_counter() - t0:.1f} s; "
                f"time summary {json.dumps(report['Time Summary'])}")


def _busy_share(run, iters: int, card: str, what: str, kernel: str) -> None:
    """Device busy time per iteration (torch.profiler) against the window
    (CUDA events around an unprofiled run of the same length), with the
    three kernels that take the most device time."""
    from hpccg_tpu_torch.utils.timing import elapsed

    run(iters)
    torch.cuda.synchronize()
    window = elapsed(lambda: run(iters), "cuda") * 1e3 / iters
    try:
        events = _profile(lambda: run(iters), reps=1, kernel=kernel)
    except AssertionError:
        say(f"[timing] {what}: window {window * 1e3:.2f} us/iter; device busy not measured (the profiler "
            f"dropped {kernel}'s events three times) [{card}]")
        return
    busy = sum(ev.device_time_total for ev in events) / 1e3 / iters
    top = sorted(events, key=lambda ev: -ev.device_time_total)[:3]
    tops = "; ".join(f"{ev.key[:60]} x{ev.count / iters:g} {ev.device_time_total / iters:.2f} us" for ev in top)
    say(f"[timing] {what}: window {window * 1e3:.2f} us/iter, device busy {busy * 1e3:.2f} us/iter, "
        f"idle share {max(0.0, 1 - busy / window):.3f}; per iteration: {tops} [{card}]")


def phase_timing(card: str) -> None:
    from hpccg_tpu_torch import ProblemConfig, generate_problem, make_cg
    from hpccg_tpu_torch.ops.cuda.stencil import spmv_stencil, spmv_stencil_plain
    from hpccg_tpu_torch.utils.timing import time_loop_slope

    cells = [(MAIN_SHAPE, torch.float32, ("stencil", "pallas", "pallas_fused", "megakernel", "streamkernel")),
             ((256, 256, 256), torch.float32, ("stencil", "pallas", "pallas_fused", "megakernel", "streamkernel")),
             ((256, 256, 256), torch.bfloat16, ("megakernel", "streamkernel", "pallas", "pallas_fused"))]
    for dims, dtype, backends in cells:
        prob = generate_problem(ProblemConfig(*dims, stencil=27, dtype=dtype), device="cuda")
        n = prob.total_nrow
        tag = f"{dims[0]}^3 {str(dtype)[6:]}"
        for backend in backends:
            last = []

            def run(k):
                last.append(make_cg(prob.A, max_iter=k + 1, tolerance=0.0, backend=backend)(prob.b, prob.x0))

            t = time_loop_slope(run, device="cuda", short=65, long=1025)
            say(f"[timing] {tag} {backend}: {t * 1e6:.2f} us/iter, "
                f"{27 * n / t / 1e9:.1f} Gnnz/s (long-leg niters {int(last[-1].niters)}) [{card}]")
            if backend in ("megakernel", "streamkernel"):
                _busy_share(run, 200, card, f"{tag} {backend} one 200-iteration solve", "wholesolve_kernel")
            if backend == "pallas_fused" and dims == BF16_SHAPE:
                _busy_share(run, 200, card, f"{tag} {backend} one 200-iteration solve", "stencil_kernel")
        if dtype == torch.float32:
            u = prob.A.grid(prob.b)
            out = torch.empty_like(u)
            t_k = _graph_ms(lambda: spmv_stencil(prob.A, u, out=out), reps=100)
            t_p = _graph_ms(lambda: spmv_stencil_plain(prob.A, u, out=out), reps=100)
            say(f"[timing] {tag} K1 {t_k * 1e3:.2f} us vs plain matvec {t_p * 1e3:.2f} us "
                f"({27 * n / (t_k / 1e3) / 1e9:.1f} vs {27 * n / (t_p / 1e3) / 1e9:.1f} Gnnz/s) [{card}]")


def phase_timing_explicit(card: str, stats: dict) -> None:
    """us per CG iteration at 128^3, float32 and float64, slope-timed (legs
    of 17 and 145 iterations): DIA and ELL on auto (K9-K12), the ELL on
    stencil (its plain version), and the randomly permuted matrix on auto as
    loaded (K13's kernel, with its busy share) and after RCM; then
    K9-K12's device time per launch from phase 3 with effective GB/s."""
    from hpccg_tpu_torch import make_cg
    from hpccg_tpu_torch.utils.timing import time_loop_slope

    twin, _, rcm, perm, _ = _permuted_128()
    index = torch.from_numpy(perm)
    n = twin.total_nrow
    for dtype in SPARSE_DTYPES:
        prob, dia = _explicit_128(dtype)
        cells = [("DIA auto", dia, prob.b, prob.x0, "auto"), ("ELL auto", prob.A, prob.b, prob.x0, "auto"),
                 ("ELL stencil (plain)", prob.A, prob.b, prob.x0, "stencil"),
                 ("permuted ELL as loaded, auto", _permuted_128_on_card(dtype), twin.b.to("cuda", dtype),
                  twin.x0.to("cuda", dtype), "auto"),
                 ("permuted ELL after RCM, auto", _cast(rcm, dtype), twin.b[index].to("cuda", dtype),
                  twin.x0[index].to("cuda", dtype), "auto")]
        for tag, A, b, x0, backend in cells:
            last = []

            def run(k):
                last.append(make_cg(A, max_iter=k + 1, tolerance=0.0, backend=backend)(b, x0))

            t = time_loop_slope(run, device="cuda", short=17, long=145)
            say(f"[timing] 128^3 {str(dtype)[6:]} {tag}: {t * 1e6:.2f} us/iter, {27 * n / t / 1e9:.1f} Gnnz/s "
                f"(long-leg niters {int(last[-1].niters)}) [{card}]")
            if backend == "auto" and not tag.startswith("permuted"):
                _busy_share(run, EXPLICIT_ITERS, card, f"128^3 {str(dtype)[6:]} {tag} one {EXPLICIT_ITERS}-iteration "
                            "solve", "dia_spmv_kernel" if tag.startswith("DIA") else "ell_spmv_kernel")
            if tag.startswith("permuted ELL as loaded"):  # the layout (and its host RCM) built once, before
                solve = make_cg(A, max_iter=EXPLICIT_ITERS, tolerance=0.0)
                _busy_share(lambda k: solve(b, x0), EXPLICIT_ITERS, card, f"128^3 {str(dtype)[6:]} {tag} one "
                            f"{EXPLICIT_ITERS}-iteration solve, its layout built before", "scatter_spmv_kernel")
    for name, model in ((K9, _dia_bytes(_explicit_128(torch.float32)[1])),
                        (K10, _dia_bytes(_explicit_128(torch.float64)[1])),
                        (K11, _ell_bytes(_explicit_128(torch.float32)[0].A)),
                        (K12, _ell_bytes(_explicit_128(torch.float64)[0].A))):
        st = stats[name]
        say(f"[timing] {name} at 128^3: {st['ms'] * 1e3:.1f} us per launch vs plain {st['plain_ms'] * 1e3:.1f} "
            f"({_gbs(model, st['ms']):.0f} vs {_gbs(model, st['plain_ms']):.0f} GB/s of {model / 1e6:.0f} MB) "
            f"[{card}]")


# ------------------------------------------------------------ slice 4: the distributed stencil path

COLL_NDEVS = [1, 2, 4, 6, 8]  # the rank counts of tests/test_collective.py, every rank on one card
# per-rank shapes of the kernel-vs-plain phase: two unaligned ones, 128x64x16,
# and one whose work items outnumber a rank's blocks at 8 ranks (50 tiles of
# 32 V x 8 points against at most 3 x 132 / 8 blocks, whatever z chunk the
# geometry takes)
COLL_SHAPES = [(33, 17, 9), (64, 48, 13), (128, 64, 16), (64, 400, 9)]
COLL_MULTI = (64, 400, 9)
COLL_ITERS = 30
# pipecg against another pipecg run (trace rtol, floor) and x: its w = A r
# and z = A s recurrences carry each run's rounding forward, and two runs
# part faster than cg's. Readings over this phase's cases on an H100
# (PERF.md): f32 trace 2.8e-3 above 1e-4 of trace[0], x 8.7e-5; f64
# trace 1.7e-9 above 1e-9, x 1.6e-13.
# Near that floor f32 pipecg parts with the dots' order alone: at 2 x
# 128x512x16 two plain versions part by 1.03e-2 on an H100
# (scripts/pipecg_f32_sum_order.py --device cuda), so no case of that
# size is held to these limits.
PIPE_TRACE = {torch.float32: (1e-2, 1e-4), torch.float64: (1e-6, 1e-9)}
PIPE_X_RTOL = {torch.float32: 2e-3, torch.float64: 1e-12}
# The main path's 150-iteration one-reduction solves. A float32 pipecg
# recurrence residual follows the exact trajectory only until the true
# residual stagnates, then each run's rounding, with spikes: on the CPU the
# JAX package's f32 pipecg and the port's plain one part by 0.99 at 1e-3 of
# trace[0] (tests/test_torch_methods.py, PERF.md). So a one-reduction
# trace is held over the iterations where the stencil cg trace is above
# MAIN_HEAD[method] of trace[0], within MAIN_TRACE[method] = (rtol against
# its plain version, against the stencil cg trace) (the tests hold the
# port's plain f32 pipecg to its f64 trajectory within 1e-3 there;
# readings on an H100: K15 cg1 3.2e-6 from its plain version, K16 1.1e-4
# from its plain version and 7.2e-5 from stencil cg). Its float32 x is
# held by its true residual ||b - A x|| / ||b|| within MAIN_X: the
# attainable accuracy of f32 pipecg after 150 iterations follows the
# rounding, 1.3e-4 to 7.9e-1 at 64^3 for the port's plain version on the
# CPU as the thread count alone changes its sums (the tests), so its x is
# only held to be better than x0 = 0; K15 cg1 reaches 1.4e-6 to 1.6e-6 on
# an H100. The float64 solves of both methods hold x to the plain
# version's: MAIN_F64 = (trace rtol, floor, x rtol of max|x|) (the tests
# hold the port's plain f64 pipecg to the JAX package's within 1e-9 of
# max|x| over 150 iterations; readings on an H100: K15 cg1 trace 1.1e-14,
# x 3.3e-15; K16 trace 6.5e-9 above 1e-9, x 4.5e-11).
MAIN_HEAD = {"cg1": 1e-5, "pipecg": 1e-3}
MAIN_TRACE = {"cg1": (1e-4, 1e-3), "pipecg": (1e-3, 1e-3)}
MAIN_X = {"cg1": 1e-5, "pipecg": 1.0}
MAIN_F64 = {"cg1": (1e-9, 1e-9, 1e-12), "pipecg": (1e-6, 1e-9, 1e-8)}
METHOD_KERNEL = {"cg": K15, "cg1": K15, "pipecg": K16}


def _head_rel(tr, ref, rtol, floor, what) -> float:
    """max |tr - ref| / ref over the entries where ref > floor * ref[0]
    (below, a one-reduction recurrence residual follows each run's rounding
    and may flush to 0); fails above rtol."""
    head = ref > floor * ref[0]
    worst = float(((tr - ref).abs() / ref)[head].max())
    if not worst <= rtol:
        raise AssertionError(f"{what}: trace {worst:.3e} from the reference above {floor} of trace[0]")
    return worst


def _one_card(ndev):
    """A mesh of ndev ranks, every one on cuda:0."""
    from hpccg_tpu_torch.parallel import make_mesh

    return make_mesh(ndev, devices=["cuda:0"] * ndev)


def _coll_kernel(method):
    """The wrapper of the collective kernel that runs ``method``."""
    from hpccg_tpu_torch.ops.cuda import collective as col

    if method == "pipecg":
        return col.cg_collective_pipelined
    return functools.partial(col.cg_collective, method=method)


def _coll_limits(method, dtype):
    """(trace rtol, floor, x rtol) of a collective solve against its plain
    version."""
    rtol, floor = (PIPE_TRACE if method == "pipecg" else WS_TRACE)[dtype]
    return rtol, floor, (PIPE_X_RTOL if method == "pipecg" else WS_X_RTOL)[dtype]


def _coll_case(op, prob, method, dtype, stencil, what) -> tuple:
    """One collective solve against its plain version, COLL_ITERS
    iterations (7-point: stopped at the floor, on a tolerance between two
    of the plain trace's entries, as phase_whole_solve_kernels does: it
    flushes below): niters equal, the trace within _coll_limits above the
    floor, x, and two launches bit-identical. Returns (niters, trace
    error, max|x - x_plain|)."""
    from hpccg_tpu_torch.ops.cuda import collective as col

    rtol, floor, xrtol = _coll_limits(method, dtype)
    want = col.solve_plain(op, prob.b, prob.x0, method=method, max_iter=COLL_ITERS)
    tol = _ws_tolerance(want.trace, floor) if stencil == 7 else 0.0
    if tol:
        want = col.solve_plain(op, prob.b, prob.x0, method=method, max_iter=COLL_ITERS, tolerance=tol)
    kern = _coll_kernel(method)
    got, again = (kern(op, prob.b, prob.x0, max_iter=COLL_ITERS, tolerance=tol) for _ in range(2))
    torch.cuda.synchronize()
    if int(got.niters) != int(want.niters):
        raise AssertionError(f"{what}: niters {int(got.niters)} vs plain {int(want.niters)}")
    n = int(want.niters) + 1
    ref = want.trace[:n].double().cpu()
    worst = _head_rel(got.trace[:n].double().cpu(), ref, rtol, floor, what)
    if not bool(torch.isnan(got.trace[n:]).all()):
        raise AssertionError(f"{what}: trace entries past niters")
    gx, wx = torch.cat(got.x), torch.cat(want.x)
    # a flush of both r.r and r.u (f32 cg1, 7-point) turns x to NaN on both
    # sides one iteration later: the reference recurrence's 0/0
    nan = torch.isnan(wx)
    if not torch.equal(torch.isnan(gx), nan):
        raise AssertionError(f"{what}: x is NaN where the plain version's is not")
    xerr = float((gx - wx)[~nan].abs().max()) if not bool(nan.all()) else 0.0
    if not xerr <= xrtol * float(wx[~nan].abs().max() if not bool(nan.all()) else 1.0):
        raise AssertionError(f"{what}: max|x - x_plain| = {xerr:.3e}")
    same = all(torch.equal(_bits(a), _bits(b)) for a, b in zip(got.x, again.x))
    if not (same and torch.equal(_bits(got.trace), _bits(again.trace))):
        raise AssertionError(f"{what}: two launches differ")
    return n - 1, worst, xerr


COLL_EDGES = ["nx<V", "nx=100", "nx=TX-1", "nx=TX+1", "ny%TY", "nz=ZC-1", "nz=ZC+1"]


def _coll_edge_shape(edge, ndev, dtype, stencil):
    """A rank's (nx, ny, nz) at ``edge`` of K15/K16's geometry for ``dtype``
    at ``ndev`` ranks (tests/test_torch_collective_edges.py): a thread's V
    points (16 bytes), the tile's width TX = 32 V and height TY, and its z
    chunk ZC, which the geometry picks per grid and rank count: the z edges
    are grids whose chosen chunk is one above or one below their nz."""
    from hpccg_tpu_torch.config import Stencil
    from hpccg_tpu_torch.operators import StencilOperator
    from hpccg_tpu_torch.ops.cuda import collective as col

    def geo(nx, ny, nz):
        return col.geometry(StencilOperator(nx, ny, nz, Stencil(stencil), dtype), ndev, dtype, "cg")

    g = geo(64, 64, 64)
    tx, ty = g.tile_x, g.tile_y
    shapes = {"nx<V": (max(tx // 32 - 1, 1), ty + 3, 5), "nx=100": (100, ty + 3, 7), "nx=TX-1": (tx - 1, ty + 1, 6),
              "nx=TX+1": (tx + 1, 2 * ty + 1, 5), "ny%TY": (33, 3 * ty + 5, 9)}
    if edge in shapes:
        return shapes[edge]
    zc = geo(tx * 8, ty * 128, 4096).z_chunk
    while zc >= 2:
        nz = zc - 1 if edge == "nz=ZC-1" else zc + 1
        for ky in range(1, 4096):
            if geo(tx + 1, ty * ky + 1, nz).z_chunk == zc:
                return tx + 1, ty * ky + 1, nz
        zc //= 2
    raise AssertionError(f"no grid at {edge}")


def _coll_edge_cases(dtype):
    """One case per edge of the staged tile for ``dtype``: (tag, ndev,
    dims, stencil, b/x0 view offsets), the rank counts 1, 2, 4, 8 in turn,
    27-point on the even edges and 7-point on the odd ones; then b and x0
    shards that are views at element offsets 1 and 3 at 4 ranks."""
    cases = []
    for i, edge in enumerate(COLL_EDGES):
        ndev, stencil = COLL_BF16_NDEVS[i % 4], 27 if i % 2 == 0 else 7
        cases.append((edge, ndev, _coll_edge_shape(edge, ndev, dtype, stencil), stencil, None))
    cases.append(("views", 4, (128, 9, 7), 27, (1, 3)))
    return cases


def _coll_edge_problem(ndev, dims, stencil, dtype, offsets):
    """The sharded problem of an edge case; with ``offsets``, b and x0 copied
    into views at those element offsets."""
    from hpccg_tpu_torch import ProblemConfig
    from hpccg_tpu_torch.parallel import generate_problem_sharded
    from hpccg_tpu_torch.parallel.cg import local_operator

    cfg = ProblemConfig(*dims, stencil=stencil, dtype=dtype)
    op, prob = local_operator(cfg), generate_problem_sharded(cfg, _one_card(ndev))
    return op, _at_offsets(prob, offsets) if offsets else prob


def _at_offsets(prob, offsets):
    """The sharded problem with b and x0 copied into views at ``offsets``
    (elements) past a fresh allocation's start."""
    def view(v, k):
        return torch.empty((v.numel() + k,), dtype=v.dtype, device=v.device)[k:].copy_(v)

    return dataclasses.replace(prob, b=tuple(view(v, offsets[0]) for v in prob.b),
                               x0=tuple(view(v, offsets[1]) for v in prob.x0))


def phase_collective_kernels() -> dict:
    """K15 (cg, cg1) and K16 (pipecg) against their plain versions with
    every rank on cuda:0, at 1, 2, 4, 6 and 8 ranks, COLL_ITERS iterations:
    per rank 33x17x9 (27- and 7-point), 64x48x13, 128x64x16 and COLL_MULTI
    (27-point; at 8 ranks COLL_MULTI's work items outnumber a rank's
    blocks), float32 and float64; then at the staged tile's edges, one
    case each (_coll_edge_cases), and on b/x0 views at odd offsets. As
    _coll_case holds them; each line gives the grid and the access widths
    (state and landing planes; with b and x0) the launches ran at. Returns
    K15/K16's max|x - x_plain| over all cases."""
    from hpccg_tpu_torch import ProblemConfig
    from hpccg_tpu_torch.ops.cuda import collective as col
    from hpccg_tpu_torch.parallel import generate_problem_sharded
    from hpccg_tpu_torch.parallel.cg import local_operator

    stats = {name: {"max_abs_err": 0.0} for name in SLICE4}
    multi = 0

    def case(op, prob, ndev, dtype, stencil, tag):
        line = []
        for method in ("cg", "cg1", "pipecg"):
            n, worst, xerr = _coll_case(op, prob, method, dtype, stencil, f"{METHOD_KERNEL[method].split()[0]} "
                                        f"{method} {tag}")
            stat = stats[METHOD_KERNEL[method]]
            stat["max_abs_err"] = max(stat["max_abs_err"], xerr)
            g = col.geometry(op, ndev, dtype, method)
            line.append(f"{method} niters {n} trace {worst:.1e} x {xerr:.1e} ({g.items} items/"
                        f"{g.blocks_per_rank} blocks, zc {g.z_chunk}, access {col.launch.access})")
        say(f"[collective] {tag}: ok, bit-identical; " + "; ".join(line))
        return g

    for ndev in COLL_NDEVS:
        mesh = _one_card(ndev)
        for dims in COLL_SHAPES:
            for stencil in (27, 7) if dims == COLL_SHAPES[0] else (27,):
                for dtype in (torch.float32, torch.float64):
                    cfg = ProblemConfig(*dims, stencil=stencil, dtype=dtype)
                    op, prob = local_operator(cfg), generate_problem_sharded(cfg, mesh)
                    g = case(op, prob, ndev, dtype, stencil,
                             f"{ndev} x {dims[0]}x{dims[1]}x{dims[2]} {stencil}pt {str(dtype)[6:]}")
                    multi += int(dims == COLL_MULTI and g.items > g.blocks_per_rank)
    if not multi:
        raise AssertionError(f"{COLL_MULTI}: no rank count gave a rank more work items than blocks")
    for dtype in (torch.float32, torch.float64):
        for edge, ndev, dims, stencil, offsets in _coll_edge_cases(dtype):
            op, prob = _coll_edge_problem(ndev, dims, stencil, dtype, offsets)
            case(op, prob, ndev, dtype, stencil, f"{edge}: {ndev} x {dims[0]}x{dims[1]}x{dims[2]} {stencil}pt "
                 f"{str(dtype)[6:]}")
    return stats


def phase_collective_across_cards() -> None:
    """K15 (cg, cg1) and K16 (pipecg) across cards on their main path:
    make_distributed_cg(backend="collective") over make_mesh(devices=
    cuda:0 ... cuda:N-1), every card of the machine (two or more), one rank
    a card at 64^3 a rank (the weak-scaling cell's shape), float64 and
    float32, COLL_ITERS iterations: held to the plain version as
    _coll_case holds it (niters, the trace above its floor, x), to the same
    ranks launched together on cuda:0 (niters equal, the trace and x within
    1e-12 relative), and counted as one launch of the wrapper per card, the
    count set to 0 just before. Then the cell's own solve (float64 cg, 150
    iterations) against the plain version (niters 149, the trace within
    1e-9 relative, x within 1e-10) and the one-card launch (1e-12). On a
    one-card machine it says so and stops."""
    from hpccg_tpu_torch import ProblemConfig
    from hpccg_tpu_torch.ops.cuda import collective as col
    from hpccg_tpu_torch.parallel import generate_problem_sharded, make_distributed_cg, make_mesh
    from hpccg_tpu_torch.parallel.cg import local_operator

    cards = torch.cuda.device_count()
    if cards < 2:
        say(f"[collective] across cards: not run, this machine has {cards} card")
        return
    devices = [torch.device("cuda", i) for i in range(cards)]
    mesh = make_mesh(devices=devices)

    def rel(a, b) -> float:
        return float(((a - b).abs() / b.abs().clamp_min(torch.finfo(b.dtype).tiny)).max())

    def held(cfg, method, iters, limits, what):
        op = local_operator(cfg)
        one = generate_problem_sharded(cfg, _one_card(cards))
        b = tuple(v.to(d) for v, d in zip(one.b, devices))
        x0 = tuple(v.to(d) for v, d in zip(one.x0, devices))
        kw = dict(max_iter=iters, tolerance=0.0, backend="collective", method=method)
        plain = col.solve_plain(op, one.b, one.x0, method=method, max_iter=iters)
        want = make_distributed_cg(cfg, _one_card(cards), **kw)(one.b, one.x0)
        wrapper = col.cg_collective_pipelined if method == "pipecg" else col.cg_collective
        wrapper.launches = 0
        got = make_distributed_cg(cfg, mesh, **kw)(b, x0)
        for d in devices:
            torch.cuda.synchronize(d)
        if wrapper.launches != cards:
            raise AssertionError(f"{what}: {wrapper.launches} launches, expected one per card ({cards})")
        n = int(got.niters)
        if not n == int(want.niters) == int(plain.niters) == iters - 1:
            raise AssertionError(f"{what}: niters {n}, one card {int(want.niters)}, plain {int(plain.niters)}")
        tr, one_tr = got.trace[:n + 1].double().cpu(), want.trace[:n + 1].double().cpu()
        gx = torch.cat([x.to(devices[0]) for x in got.x]).double()
        wx, px = torch.cat(want.x).double(), torch.cat(plain.x).double()
        one_card = max(rel(tr, one_tr), rel(gx, wx))
        if not one_card <= 1e-12:
            raise AssertionError(f"{what}: {one_card:.3e} from the one-card launch")
        rtol, floor, xrtol = limits
        worst = _head_rel(tr, plain.trace[:n + 1].double().cpu(), rtol, floor, what)
        xerr = float((gx - px).abs().max())
        if not xerr <= xrtol * float(px.abs().max()):
            raise AssertionError(f"{what}: max|x - x_plain| = {xerr:.3e}")
        say(f"[collective] {what}: ok; niters {n}, launches {wrapper.launches}; one card {one_card:.1e}; plain: "
            f"trace {worst:.1e}, x {xerr:.1e}")

    for dtype in (torch.float64, torch.float32):
        cfg = ProblemConfig(64, 64, 64, dtype=dtype)
        for method in ("cg", "cg1", "pipecg"):
            held(cfg, method, COLL_ITERS, _coll_limits(method, dtype),
                 f"{METHOD_KERNEL[method].split()[0]} {method} {cards} cards x 64^3 {str(dtype)[6:]}")
    held(ProblemConfig(64, 64, 64, dtype=torch.float64), "cg", 150, (1e-9, 0.0, 1e-10),
         f"K15 cg {cards} cards x 64^3 float64, 150 iterations")


# the slice's main path: (label, ranks, per-rank block); the reference's
# headline unit, its weak-scaling protocol (64^3 per rank, BASELINE.md:19)
# and its strong-scaling protocol (64x64x1024 global on 8 ranks, :20)
# slice 10's: 4 x 100^3, the collective kernels with their state past the L2
BIG_COLL_CELL = ("4 x 100^3", 4, (100, 100, 100))
MAIN_CELLS = [("1 x 100^3", 1, (100, 100, 100))] + [
    (f"weak {n} x 64^3", n, (64, 64, 64)) for n in (1, 2, 4, 8)] + [
    ("strong 64x64x1024 on 8", 8, (64, 64, 128))]
MAIN_RUNS = [("collective", "cg"), ("collective", "cg1"), ("collective", "pipecg"), ("pallas_fused", "cg"),
             ("stencil", "cg")]


def _true_residual(op, bs, xs) -> float:
    """||b - A x|| / ||b|| of a sharded solve, in float64."""
    from hpccg_tpu_torch.parallel.halo import stencil_matvec_halo

    x = tuple(v.double() for v in xs)
    ax = stencil_matvec_halo(dataclasses.replace(op, dtype=torch.float64), x)
    r = torch.cat([b.double() - v for b, v in zip(bs, ax)])
    return float(r.norm() / torch.cat([v.double() for v in bs]).norm())


def _one_reduction_check(res, plain, ref_trace, op, prob, method, what) -> str:
    """A float32 cg1/pipecg solve against its plain version and the stencil
    cg trace (MAIN_HEAD, MAIN_TRACE, MAIN_X)."""
    niters, pn = int(res.niters), int(plain.niters)
    early = res if niters < pn else plain
    if niters != pn and float(early.normr) != 0.0:
        raise AssertionError(f"{what}: niters {niters} vs its plain version's {pn}, no flush to 0")
    n = min(niters, pn) + 1
    head = ref_trace[:n] > MAIN_HEAD[method] * ref_trace[0]
    tr, pt, cg = res.trace[:n].double().cpu(), plain.trace[:n].double().cpu(), ref_trace[:n]
    worst = [float(((a - b).abs() / b)[head].max()) for a, b in ((tr, pt), (tr, cg), (pt, cg))]
    rtol_plain, rtol_cg = MAIN_TRACE[method]
    if not (worst[0] <= rtol_plain and max(worst[1:]) <= rtol_cg):
        raise AssertionError(f"{what}: traces (kernel-plain, kernel-cg, plain-cg) {worst} over the {int(head.sum())} "
                             f"iterations above {MAIN_HEAD[method]} of trace[0]")
    got, want = (_true_residual(op, prob.b, r.x) for r in (res, plain))
    # a flush of both r.r and r.u turns the plain x to NaN one iteration later (the reference recurrence's 0/0)
    if not (got <= MAIN_X[method] and (want <= MAIN_X[method] or math.isnan(want))):
        raise AssertionError(f"{what}: true residual {got:.3e}, plain {want:.3e}, limit {MAIN_X[method]}")
    return (f"plain niters {pn}; trace within {worst[0]:.2e} of plain, {worst[1]:.2e} of stencil cg over "
            f"{int(head.sum())} iterations; true residual {got:.2e} (plain {want:.2e})")


def _f64_check(res, plain, method, what) -> str:
    """A float64 cg1/pipecg solve against its plain version (MAIN_F64)."""
    rtol, floor, xrtol = MAIN_F64[method]
    if int(res.niters) != int(plain.niters) or int(res.niters) != 149:
        raise AssertionError(f"{what}: niters {int(res.niters)}, plain {int(plain.niters)}")
    worst = _head_rel(res.trace.double().cpu(), plain.trace.double().cpu(), rtol, floor, what)
    gx, wx = torch.cat(res.x), torch.cat(plain.x)
    xerr = float((gx - wx).abs().max())
    if not xerr <= xrtol * float(wx.abs().max()):
        raise AssertionError(f"{what}: max|x - x_plain| = {xerr:.3e}")
    return f"trace within {worst:.2e} of plain above {floor} of trace[0]; x {xerr:.2e}"


def _main_path_slice4(cells=None, runs=None, f64=True) -> None:
    """make_distributed_cg at full width on every MAIN_CELLS cell, float32,
    max_iter 150, tolerance 0: collective (cg, cg1, pipecg; one launch of
    K15/K16 each), pallas_fused and stencil, against the single-device
    stencil solve of the same global grid; then collective cg1 and pipecg
    in float64. cg runs 149 iterations. cg1 and pipecg are held to their
    plain versions' niters, except where one of the two stopped early on an
    exact 0 (the f32 cg1 recurrence residual flushes at an iteration that
    depends on the rounding: 143 against 149 at 64^3 on one H100 run), and
    as _one_reduction_check and _f64_check hold them. ``cells``, ``runs``
    and ``f64`` narrow it (slice 10's path)."""
    from hpccg_tpu_torch import ProblemConfig, generate_problem, make_cg
    from hpccg_tpu_torch.ops.cuda import collective as col
    from hpccg_tpu_torch.parallel import generate_problem_sharded, make_distributed_cg
    from hpccg_tpu_torch.parallel.cg import local_operator

    def run(cfg, mesh, prob, backend, method):
        before = _counts()
        res = make_distributed_cg(cfg, mesh, max_iter=150, tolerance=0.0, backend=backend, method=method)(
            prob.b, prob.x0)
        torch.cuda.synchronize()
        return res, {n: c - before[n] for n, c in _counts().items()}

    def one_launch(delta, method, what):
        kernel = METHOD_KERNEL[method]
        if delta[kernel] != 1 or _launch_sum(delta) != 1:
            raise AssertionError(f"{what}: expected one launch of {kernel}, got {delta}")

    for label, ndev, dims in cells or MAIN_CELLS:
        cfg = ProblemConfig(*dims, dtype=torch.float32)
        op = local_operator(cfg)
        mesh = _one_card(ndev)
        prob = generate_problem_sharded(cfg, mesh)
        gprob = generate_problem(ProblemConfig(dims[0], dims[1], dims[2] * ndev, dtype=torch.float32), "cuda")
        ref = make_cg(gprob.A, max_iter=150, tolerance=0.0, backend="stencil")(gprob.b, gprob.x0)
        ref_trace, ref_x = ref.trace.double().cpu(), ref.x
        for backend, method in runs or MAIN_RUNS:
            what = f"{label} {backend} {method}"
            res, delta = run(cfg, mesh, prob, backend, method)
            niters, x = int(res.niters), torch.cat(res.x)
            if not bool(torch.isfinite(x).all()) or not math.isfinite(float(res.normr)):
                raise AssertionError(f"{what}: non-finite x or normr")
            if method == "cg":
                if niters != 149:
                    raise AssertionError(f"{what}: niters {niters}")
                worst, tail = _trace_check(res.trace.double().cpu(), ref_trace, what)
                xerr = float((x - ref_x).abs().max())
                if not xerr <= 1e-4:
                    raise AssertionError(f"{what}: max|x - x_stencil| {xerr:.3e}")
                note = f"trace within {worst:.2e} of single-device stencil's, {tail:.2e} below; x {xerr:.2e}"
            else:
                plain = col.solve_plain(op, prob.b, prob.x0, method=method, max_iter=150)
                note = _one_reduction_check(res, plain, ref_trace, op, prob, method, what)
            if backend == "collective":
                one_launch(delta, method, what)
            elif backend == "pallas_fused":
                if min(delta[n] for n in SLICE1[2:]) <= 0 or delta[K3N] or delta[K4S]:
                    raise AssertionError(f"{what}: K3/K4/finalize not all launched, or K4s's route: {delta}")
            elif any(delta.values()):
                raise AssertionError(f"{what}: the stencil backend launched a kernel")
            say(f"[main] {what}: niters {niters} normr {float(res.normr):.6e}; {note}; launches {_launch_note(delta)}")
        if not f64:
            continue
        cfg64 = ProblemConfig(*dims, dtype=torch.float64)
        prob64 = generate_problem_sharded(cfg64, mesh)
        for method in ("cg1", "pipecg"):
            what = f"{label} collective {method} f64"
            res, delta = run(cfg64, mesh, prob64, "collective", method)
            plain = col.solve_plain(local_operator(cfg64), prob64.b, prob64.x0, method=method, max_iter=150)
            note = _f64_check(res, plain, method, what)
            one_launch(delta, method, what)
            say(f"[main] {what}: niters {int(res.niters)} normr {float(res.normr):.6e}; {note}; launches "
                f"{_launch_note(delta)}")


def _main_path_slice10() -> None:
    """K15/K16 past the L2: make_distributed_cg on collective (cg, cg1,
    pipecg; one launch each) at 4 x 100^3 float32 (80 MB of state), max_iter
    150, held as _main_path_slice4 holds its cells."""
    _main_path_slice4([BIG_COLL_CELL], [("collective", m) for m in ("cg", "cg1", "pipecg")], f64=False)


def phase_golden_collective() -> None:
    """The golden run as two 10x10x5 float64 ranks on collective, method cg."""
    from hpccg_tpu_torch import ProblemConfig
    from hpccg_tpu_torch.parallel import generate_problem_sharded, make_distributed_cg

    cfg = ProblemConfig(10, 10, 5, dtype=torch.float64)
    mesh = _one_card(2)
    prob = generate_problem_sharded(cfg, mesh)
    res = make_distributed_cg(cfg, mesh, max_iter=150, tolerance=0.0, backend="collective", method="cg")(
        prob.b, prob.x0)
    _check_golden(res.trace.cpu().numpy(), int(res.niters), "2 ranks x 10x10x5 on collective (K15, cg)")


def phase_cli_methods() -> None:
    """The single-device methods through the CLI at 100^3: cg1 in float32
    (its recurrence residual may flush to 0 near iteration 140: niters is
    printed, not held to 149), pipecg with replacement every 50 iterations
    (149), and float64 refinement, 3 rounds."""
    for extra in (["--dtype", "float32", "--method", "cg1"],
                  ["--dtype", "float32", "--method", "pipecg", "--rr-every", "50"],
                  ["--dtype", "float64", "--refine", "3"]):
        report, trace, _ = _cli(["100", "100", "100", "--json", *extra], " ".join(extra))
        n, final = report["Number of iterations"], report["Final residual"]
        if not (n > 100 and math.isfinite(final)) or ("--rr-every" in extra and n != 149):
            raise AssertionError(f"cli {' '.join(extra)}: {n} iterations, final residual {final}")
        if "--refine" in extra and not final < 1e-10 * trace[0]:
            raise AssertionError(f"cli --refine 3: final residual {final} against {trace[0]}")
        say(f"[cli] {' '.join(extra)}: rc 0, iterations {n}, final residual {final:.6e}, "
            f"time summary {json.dumps(report['Time Summary'])}")


def phase_timing_collective(card: str, stats: dict) -> None:
    """Slope-timed us per iteration (legs of 17 and 97 iterations, below
    the f32 cg1 flush): collective (cg, cg1, pipecg) at 1 x 100^3 beside
    the single-device megakernel, and at 4 x 100^3 and 8 x 64^3 beside
    distributed pallas_fused. N ranks share one card here: these are no
    scaling numbers. Then K15 (cg) and K16 against their plain versions at
    1 x 100^3 and at 4 x 100^3 (the kernels line's 4 x 100^3 rows, past
    the L2, with their own check against the plain version: _coll_case),
    plain, kernel, kernel, plain."""
    from hpccg_tpu_torch import ProblemConfig, generate_problem, make_cg
    from hpccg_tpu_torch.ops.cuda import collective as col
    from hpccg_tpu_torch.parallel import generate_problem_sharded, make_distributed_cg
    from hpccg_tpu_torch.parallel.cg import local_operator
    from hpccg_tpu_torch.utils.timing import time_loop_slope

    def slope(run):
        return time_loop_slope(run, device="cuda", short=17, long=97) * 1e6

    for ndev, dims in ((1, (100, 100, 100)), (4, (100, 100, 100)), (8, (64, 64, 64))):
        cfg = ProblemConfig(*dims, dtype=torch.float32)
        mesh = _one_card(ndev)
        prob = generate_problem_sharded(cfg, mesh)
        n = cfg.local_nrow * ndev
        tag = f"{ndev} x {dims[0]}x{dims[1]}x{dims[2]} f32"
        runs = [("collective", m) for m in ("cg", "cg1", "pipecg")] + [("pallas_fused", "cg")]
        for backend, method in runs:
            t = slope(lambda k: make_distributed_cg(cfg, mesh, max_iter=k + 1, backend=backend, method=method)(
                prob.b, prob.x0))
            say(f"[timing] {tag} {backend} {method}: {t:.2f} us/iter, {27 * n / t / 1e3:.1f} Gnnz/s "
                f"({ndev} ranks on one card) [{card}]")
        if ndev != 4:  # one solve's device busy share: one launch (collective) against ~5 per rank
            for backend in ("collective", "pallas_fused"):
                def run(k, backend=backend):
                    make_distributed_cg(cfg, mesh, max_iter=k + 1, backend=backend)(prob.b, prob.x0)

                _busy_share(run, 100, card, f"{tag} {backend} cg one 100-iteration solve",
                            "collective_kernel" if backend == "collective" else "stencil_kernel")
        if ndev == 1:
            g = generate_problem(cfg, "cuda")
            t = slope(lambda k: make_cg(g.A, max_iter=k + 1, backend="megakernel")(g.b, g.x0))
            say(f"[timing] {tag} single-device megakernel (K5): {t:.2f} us/iter [{card}]")
    cfg = ProblemConfig(100, 100, 100, dtype=torch.float32)
    op = local_operator(cfg)
    for ndev, rows in ((1, (K15, K16)), (4, (BIG15, BIG16))):
        prob = generate_problem_sharded(cfg, _one_card(ndev))
        for name, method in zip(rows, ("cg", "pipecg")):
            kern = _coll_kernel(method)
            if ndev > 1:  # the 4 x 100^3 rows' own check against the plain version
                stats[name] = {"max_abs_err": _coll_case(op, prob, method, torch.float32, 27,
                                                         f"{name} ({method})")[2]}

            def plain(k):
                col.solve_plain(op, prob.b, prob.x0, method=method, max_iter=k + 1)

            def kernel(k):
                kern(op, prob.b, prob.x0, max_iter=k + 1)

            t_p1, t_k1, t_k2, t_p2 = (slope(f) for f in (plain, kernel, kernel, plain))
            stats[name]["ms"], stats[name]["plain_ms"] = (t_k1 + t_k2) / 2e3, (t_p1 + t_p2) / 2e3
            # one iteration: its state read and written once (cg: x, r, p; pipecg: x, r, w, p, s, z)
            nvec = 6 if method == "cg" else 12
            n = op.local_nrow * ndev
            _model(stats[name], nvec * n * 4, 2 * op.nnz * ndev + 2 * nvec * n, 4)
            say(f"[timing] {name} ({method}) at {ndev} x 100^3 f32: {stats[name]['ms'] * 1e3:.2f} us/iter vs plain "
                f"{stats[name]['plain_ms'] * 1e3:.2f}, bound {_bound(stats[name])[0] * 1e3:.2f} [{card}]")


# ------------------------------------------------------------ slice 5: distributed file mode

# K17 against its plain version: (label, rows per rank, the band's positive
# offsets or None for scattered ones within +-200); every band symmetric
# and diagonally dominant, as the CG problems are
DIA_CASES = [("scattered band within +-200, 2048 rows/rank", 2048, None),
             ("scattered band within +-200, 100000 rows/rank", 100_000, None),
             ("diagonal only, 4096 rows/rank", 4096, ()),
             ("band as wide as the shard (+-512), 512 rows/rank", 512, (37, 512))]
DIA_MULTI = 100_000  # its row tiles outnumber a rank's blocks at 6 and 8 ranks
DIA_ITERS = 30
FILE_NDEV = 4  # the main path: generate_ell(128^3) -> DIA on 4 ranks of one card
FILE_RUNS = [("dia-collective", "cg"), ("dia-collective", "cg1"), ("dia-halo", "cg"), ("ell-halo", "cg"),
             ("ell-allgather", "cg")]


def _sym_dia(n, pos, dtype, gen):
    """A symmetric, diagonally dominant DiaMatrix on the card: offsets 0 and
    +-o for o in ``pos``, off-diagonal values in [-1, -0.1], the diagonal in
    [2 ndiag, 2 ndiag + 1)."""
    from hpccg_tpu_torch.operators import DiaMatrix

    pos = sorted(pos)
    k = len(pos)
    data = torch.zeros((2 * k + 1, n), dtype=dtype, device="cuda")
    data[k] = 2.0 * (2 * k + 1) + torch.rand(n, generator=gen, device="cuda", dtype=dtype)
    for j, o in enumerate(pos):
        if o < n:
            v = torch.rand(n - o, generator=gen, device="cuda", dtype=dtype) * -0.9 - 0.1
            data[k + 1 + j, : n - o] = v  # A[i, i + o]
            data[k - 1 - j, o:] = v  # A[i + o, i]
    return DiaMatrix(data=data, offsets=tuple([-o for o in reversed(pos)] + [0] + pos), total_nrow=n)


def _sharded_file_problem(A, mesh, b=None):
    """The problem A x = b (b = A 1 by default, x0 = 0) through the user's
    entry points: padded to the mesh's ranks and sharded over it."""
    from hpccg_tpu_torch.io import pad_problem_rows
    from hpccg_tpu_torch.models.stencil import Problem
    from hpccg_tpu_torch.parallel import shard_problem

    n = A.local_nrow
    b = A.matvec(torch.ones(n, dtype=A.dtype, device=A.device)) if b is None else b
    prob = Problem(A=A, b=b, x0=torch.zeros_like(b), xexact=torch.ones_like(b), total_nrow=n,
                   total_nnz_model=A.nnz, total_nnz_exact=A.nnz)
    return shard_problem(pad_problem_rows(prob, mesh.size), mesh)


# K17's geometry edges (slice 11): (label, ranks, rows per rank as a
# function of the tile's rows t, the band's positive offsets, b/x0 view
# offsets). A tile is 256 threads x 4 rows (t = 1024); the data of a rank
# goes through the ring where L is a multiple of a 16-byte word's values
# (4 float32, 2 float64), else is read directly; a tile reads x without a
# select where every row's reach stays inside the rank. The last case has
# more diagonals than the offsets kept in shared memory (1024).
DIA_EDGES = [("L = tile rows - 1", 1, lambda t: t - 1, (1, 37, 200), None),
             ("L = tile rows", 2, lambda t: t, (1, 37, 200), None),
             ("L = tile rows + 1", 4, lambda t: t + 1, (1, 37, 200), None),
             ("L odd, inner tiles read directly", 6, lambda t: 8 * t + 3, (1, 37, 200), None),
             ("b/x0 views at element offsets 1 and 3", 8, lambda t: 4 * t, (1, 37, 200), (1, 3)),
             ("1101 diagonals (past the offsets in shared memory)", 2, lambda t: 2048, tuple(range(3, 1653, 3)),
              None)]


def _dia_apply_check(prob, what) -> None:
    """K17's apply bit for bit against the plain dia-halo matvec (DiaRows.matvec
    over BandStrips): a cg launch of one iteration leaves p (= r) and A p,
    as the kernel's apply computed it, in the launch's state."""
    from hpccg_tpu_torch.ops.cuda import collective as col
    from hpccg_tpu_torch.parallel.halo import BandStrips

    _, scratch = col.launch_dia(prob.A, prob.b, prob.x0, method="cg", max_iter=2)
    torch.cuda.synchronize()
    state, kinds = scratch.state, col.VECTORS["cg"]
    p, ap = state[kinds.index(col.P_P)], state[kinds.index(col.P_S)]
    first = prob.A[0]
    strips = BandStrips(first.local_nrow, first.bw_lo, first.bw_hi, [v.device for v in prob.b], first.dtype)
    ext = strips.fill(tuple(p[r] for r in range(len(prob.A))))
    for r, (blk, x) in enumerate(zip(prob.A, ext)):
        if not torch.equal(_bits(ap[r]), _bits(blk.matvec(x))):
            raise AssertionError(f"{what}: the apply of rank {r} differs from DiaRows.matvec")


def _dia_case(prob, ndev, L, dtype, tag, stats) -> tuple:
    """K17 cg and cg1 against the plain version on one sharded problem, as
    phase_collective_dia_kernels holds them, and the apply bit for bit;
    returns (the case's line, the launches' row tiles and blocks)."""
    from hpccg_tpu_torch.ops.cuda import collective as col

    line = []
    for method in ("cg", "cg1"):
        what = f"K17 {method} {tag}"
        rtol, floor, xrtol = _coll_limits(method, dtype)
        want = col.solve_plain_dia(prob.A, prob.b, prob.x0, method=method, max_iter=DIA_ITERS)
        tol = _ws_tolerance(want.trace, floor)
        if tol:
            want = col.solve_plain_dia(prob.A, prob.b, prob.x0, method=method, max_iter=DIA_ITERS, tolerance=tol)
        got, again = (col.cg_collective_dia(prob.A, prob.b, prob.x0, method=method, max_iter=DIA_ITERS,
                                            tolerance=tol) for _ in range(2))
        torch.cuda.synchronize()
        if int(got.niters) != int(want.niters):
            raise AssertionError(f"{what}: niters {int(got.niters)} vs plain {int(want.niters)}")
        n = int(want.niters) + 1
        worst = _head_rel(got.trace[:n].double().cpu(), want.trace[:n].double().cpu(), rtol, floor, what)
        if not bool(torch.isnan(got.trace[n:]).all()):
            raise AssertionError(f"{what}: trace entries past niters")
        gx, wx = torch.cat(got.x), torch.cat(want.x)
        xerr = float((gx - wx).abs().max())
        if not xerr <= xrtol * float(wx.abs().max()):
            raise AssertionError(f"{what}: max|x - x_plain| = {xerr:.3e}")
        same = all(torch.equal(_bits(a), _bits(b)) for a, b in zip(got.x, again.x))
        if not (same and torch.equal(_bits(got.trace), _bits(again.trace))):
            raise AssertionError(f"{what}: two launches differ")
        for name in (K17, K17D) if dtype == torch.float64 else (K17,):
            stats[name]["max_abs_err"] = max(stats[name]["max_abs_err"], xerr)
        line.append(f"{method} niters {n - 1} trace {worst:.1e} x {xerr:.1e}")
    _dia_apply_check(prob, f"K17 {tag}")
    tiles, bpr = col.dia_grid(L, ndev, col.dia_resident_blocks(dtype, "cg"), col.dia_tile_rows(dtype))
    return "; ".join(line) + f" ({tiles} row tiles/{bpr} blocks), apply bit-identical", (tiles, bpr)


def phase_collective_dia_kernels() -> dict:
    """K17 (cg, cg1) against its plain version with every rank on cuda:0, at
    1, 2, 4, 6 and 8 ranks, DIA_ITERS iterations, float32 and float64, on
    the DIA_CASES bands: a scattered multi-row band (at 2048 and 100000
    rows per rank: blocks take several row tiles in turns), the diagonal alone
    (no strips) and a band as wide as the shard (rows go both ways); then
    at the edges of its tile (DIA_EDGES, one rank count each, both dtypes);
    then the main path's 128^3 DIA on 4 ranks in both dtypes (the apply
    only). Limits as K15's: niters equal, the trace within WS_TRACE above
    its floor (the solve stops there, on a tolerance between two of the
    plain trace's entries), x within WS_X_RTOL, two launches bit-identical;
    and in every case the apply bit for bit against DiaRows.matvec
    (_dia_apply_check). Returns K17's max|x - x_plain| (float64's also on
    its own row)."""
    from hpccg_tpu_torch.ops.cuda import collective as col

    stats = {K17: {"max_abs_err": 0.0}, K17D: {"max_abs_err": 0.0}}
    gen = torch.Generator(device="cuda").manual_seed(5)
    multi = 0
    for ndev in COLL_NDEVS:
        mesh = _one_card(ndev)
        for label, L, pos in DIA_CASES:
            if pos is None:
                pos = sorted((torch.randperm(200, generator=gen, device="cuda")[:6] + 1).tolist())
            for dtype in (torch.float32, torch.float64):
                prob = _sharded_file_problem(_sym_dia(L * ndev, pos, dtype, gen), mesh)
                tag = f"{ndev} x {label} {str(dtype)[6:]}"
                line, (tiles, bpr) = _dia_case(prob, ndev, L, dtype, tag, stats)
                multi += int(L == DIA_MULTI and tiles > bpr)
                say(f"[collective-dia] {tag}: ok, bit-identical; {line}")
    if not multi:
        raise AssertionError(f"{DIA_MULTI} rows/rank: no rank count gave a rank more row tiles than blocks")
    for label, ndev, rows, pos, views in DIA_EDGES:
        for dtype in (torch.float32, torch.float64):
            L = rows(col.dia_tile_rows(dtype))
            prob = _sharded_file_problem(_sym_dia(L * ndev, pos, dtype, gen), _one_card(ndev))
            if views:
                prob = _at_offsets(prob, views)
            tag = f"{label}: {ndev} x {L} rows, {2 * len(pos) + 1} diagonals {str(dtype)[6:]}"
            line, _ = _dia_case(prob, ndev, L, dtype, tag, stats)
            say(f"[collective-dia] {tag}: ok, bit-identical; {line}")
    mesh = _one_card(FILE_NDEV)
    for dtype in (torch.float32, torch.float64):
        prob, dia = _explicit_128(dtype)
        _dia_apply_check(_sharded_file_problem(dia, mesh, prob.b), f"K17 4 x 128^3/4 {str(dtype)[6:]}")
        say(f"[collective-dia] 4 x 128^3/4 {str(dtype)[6:]} (the main path's matrix): the apply bit-identical to "
            "DiaRows.matvec")
    return stats


def _file_tier(tier):
    from hpccg_tpu_torch.parallel import cg as pcg

    return {"dia-collective": pcg.make_collective_dia_cg, "dia-halo": pcg.make_distributed_dia_cg,
            "ell-halo": pcg.make_distributed_ell_halo_cg, "ell-allgather": pcg.make_distributed_ell_cg}[tier]


def _main_path_slice5() -> None:
    """Distributed file mode at full width: generate_ell(128^3) (2,097,152
    rows, 27 diagonals, a band of 16,513 rows) as DIA and as ELL, padded and
    sharded over 4 ranks of one card (shard_problem), float32 and float64,
    50 iterations, on every tier: dia-collective (K17, cg and cg1; one
    launch per solve, and held against its plain version), dia-halo (K9/K10,
    4 launches per matvec), ell-halo and ell-allgather (K11/K12). Each is
    held against the single-device DIA solve (make_cg: trace and x; cg1
    against its plain version and, above 1e-5 of trace[0], against cg).
    Then the randomly permuted 64^3 float64 stencil, written as an HPC-row
    file and read back (auto_structure: RCM, then ELL), on ell-halo at 4
    ranks against its single-device solve, 150 iterations."""
    from hpccg_tpu_torch import make_cg
    from hpccg_tpu_torch.io import pad_problem_rows, read_hpc_row_structured, write_hpc_row
    from hpccg_tpu_torch.ops.cuda import collective as col
    from hpccg_tpu_torch.parallel import cg as pcg

    mesh = _one_card(FILE_NDEV)
    for dtype in (torch.float32, torch.float64):
        prob, dia = _explicit_128(dtype)
        f32 = dtype == torch.float32
        spmv = {"dia": K9 if f32 else K10, "ell": K11 if f32 else K12}
        ref = make_cg(dia, max_iter=EXPLICIT_ITERS, tolerance=0.0)(prob.b, prob.x0)
        torch.cuda.synchronize()
        shards = {"dia": _sharded_file_problem(dia, mesh, prob.b),
                  "ell": _sharded_file_problem(prob.A, mesh, prob.b)}
        if pcg.ell_band(shards["ell"].A) != (16_513, 16_513) or not pcg.collective_dia_supported(dia, mesh)[0]:
            raise AssertionError("128^3 on 4 ranks: expected a band of 16,513 rows that K17 takes")
        for tier, method in FILE_RUNS:
            what = f"4 x 128^3/4 {str(dtype)[6:]} {tier} {method}"
            sp = shards["dia" if tier.startswith("dia") else "ell"]
            before = _counts()
            res = _file_tier(tier)(mesh, max_iter=EXPLICIT_ITERS, method=method)(sp.A, sp.b, sp.x0)
            torch.cuda.synchronize()
            delta = {n: c - before[n] for n, c in _counts().items()}
            x = torch.cat(res.x)
            if int(res.niters) != EXPLICIT_ITERS - 1 or not bool(torch.isfinite(x).all()):
                raise AssertionError(f"{what}: niters {int(res.niters)}, finite x {bool(torch.isfinite(x).all())}")
            rtol, floor = EXPLICIT_TRACE[dtype]
            if method == "cg":
                worst, tail = _trace_check(res.trace.double().cpu(), ref.trace.double().cpu(), what, rtol, floor)
                note = f"trace within {worst:.2e} of the single-device DIA solve's, {tail:.2e} below"
            else:
                crtol, cfloor = (MAIN_TRACE["cg1"][1], MAIN_HEAD["cg1"]) if f32 else MAIN_F64["cg1"][:2]
                worst = _head_rel(res.trace.double().cpu(), ref.trace.double().cpu(), crtol, cfloor, what)
                note = f"trace within {worst:.2e} of the single-device DIA cg above {cfloor} of trace[0]"
            xerr = float((x.double() - ref.x.double()).abs().max())
            xlim = (1e-3 if method == "cg1" and f32 else EXPLICIT_X_RTOL[dtype]) * float(ref.x.double().abs().max())
            if not xerr <= xlim:
                raise AssertionError(f"{what}: max|x - x_single| = {xerr:.3e} > {xlim:.3e}")
            note += f"; x {xerr:.2e}"
            if tier == "dia-collective":
                if delta[K17] != 1 or _launch_sum(delta) != 1 or delta[K17D] != int(not f32):
                    raise AssertionError(f"{what}: expected one launch of K17, got {delta}")
                plain = col.solve_plain_dia(sp.A, sp.b, sp.x0, method=method, max_iter=EXPLICIT_ITERS)
                prtol, pfloor = WS_TRACE[dtype] if method == "cg" else (
                    (MAIN_TRACE["cg1"][0], MAIN_HEAD["cg1"]) if f32 else MAIN_F64["cg1"][:2])
                pworst = _head_rel(res.trace.double().cpu(), plain.trace.double().cpu(), prtol, pfloor,
                                   f"{what} vs plain")
                px = float((x - torch.cat(plain.x)).abs().max())
                if not px <= EXPLICIT_X_RTOL[dtype] * float(torch.cat(plain.x).abs().max()):
                    raise AssertionError(f"{what}: max|x - x_plain| = {px:.3e}")
                note += f"; against its plain version: trace {pworst:.2e}, x {px:.2e}"
            else:
                kernel = spmv["dia" if tier == "dia-halo" else "ell"]
                if delta[kernel] != FILE_NDEV * EXPLICIT_ITERS:  # the initial A x0 and one per iteration, per rank
                    raise AssertionError(f"{what}: {kernel} launched {delta[kernel]} times")
            say(f"[main] {what}: niters {int(res.niters)} normr {float(res.normr):.6e}; {note}; launches "
                f"{_launch_note(delta)}")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "permuted64.txt")
        t0 = time.perf_counter()
        write_hpc_row(path, _permuted(_stencil_ell((64, 64, 64), torch.float64, "cpu"), 3)[0])
        prob, perm, report = read_hpc_row_structured(path, device="cuda")
        t1 = time.perf_counter()
    if report.format != "ell+rcm":
        raise AssertionError(f"permuted 64^3 file: expected ell+rcm, got {report.format}")
    sp = pcg.shard_problem(pad_problem_rows(prob, FILE_NDEV), mesh)
    ok, reason = pcg.ell_halo_plan(sp.A, sp.A[0].local_nrow)
    if not ok:
        raise AssertionError(f"permuted 64^3 after RCM: {reason}")
    ref = make_cg(prob.A, max_iter=150, tolerance=0.0)(prob.b, prob.x0)
    before = _counts()
    res = pcg.make_distributed_ell_halo_cg(mesh, max_iter=150)(sp.A, sp.b, sp.x0)
    torch.cuda.synchronize()
    delta = {n: c - before[n] for n, c in _counts().items()}
    what = "permuted 64^3 f64 file, ell+rcm, ell-halo on 4 ranks"
    if int(res.niters) != 149 or delta[K12] != FILE_NDEV * 150:
        raise AssertionError(f"{what}: niters {int(res.niters)}, K12 launches {delta[K12]}")
    worst, tail = _trace_check(res.trace.cpu(), ref.trace.cpu(), what, 1e-10, 1e-11)
    xerr = float((torch.cat(res.x) - ref.x).abs().max())
    if not xerr <= 1e-10:
        raise AssertionError(f"{what}: max|x - x_single| = {xerr:.3e}")
    say(f"[main] {what} (band {pcg.ell_band(sp.A)}; write + read + RCM {t1 - t0:.1f} s on the host): niters 149; "
        f"trace within {worst:.2e} of the single-device solve's, {tail:.2e} below; x {xerr:.2e}; launches "
        f"{_launch_note(delta)}")


def phase_golden_file_mesh() -> None:
    """The golden run from the 10^3 float64 HPC-row file (the one slice 3
    writes), read by the user's reader, as two ranks of one card on
    dia-collective (K17, method cg)."""
    from hpccg_tpu_torch.io import read_hpc_row_structured, write_hpc_row
    from hpccg_tpu_torch.ops.cuda import collective as col
    from hpccg_tpu_torch.parallel import make_collective_dia_cg, shard_problem

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "golden10.txt")
        write_hpc_row(path, _stencil_ell((10, 10, 10), torch.float64, "cpu"))
        prob, _, report = read_hpc_row_structured(path, device="cuda")
    mesh = _one_card(2)
    sp = shard_problem(prob, mesh)
    before = col.cg_collective_dia.launches
    res = make_collective_dia_cg(mesh, max_iter=150, method="cg")(sp.A, sp.b, sp.x0)
    if report.format != "dia" or col.cg_collective_dia.launches != before + 1:
        raise AssertionError(f"golden file on 2 ranks: {report.format}, not one launch of K17")
    _check_golden(res.trace.cpu().numpy(), int(res.niters), "file on 2 ranks of one card, dia-collective (K17, cg)")


def phase_cli_file_mesh() -> None:
    """FILE --mesh 2 through the CLI: one rank per card, so it needs two
    cards (the 64^3 float64 file on dia-halo, 149 iterations). On a
    one-card machine it says so and stops: the tiers ran through the API on
    a one-card mesh in the main path."""
    from hpccg_tpu_torch.io import write_hpc_row

    cards = torch.cuda.device_count()
    if cards < 2:
        say(f"[cli] FILE --mesh 2: not run, this machine has {cards} card (--mesh N takes one card per rank; the "
            "distributed file tiers ran through the API on a one-card mesh above)")
        return
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "stencil64.txt")
        write_hpc_row(path, _stencil_ell((64, 64, 64), torch.float64, "cpu"))
        report, _, err = _cli([path, "--mesh", "2", "--json"], "FILE --mesh 2")
    note = next(k for k in report["Time Summary"] if k.startswith("("))
    if report["Number of iterations"] != 149 or "backend=distributed:dia-halo" not in note:
        raise AssertionError(f"cli FILE --mesh 2: {report['Number of iterations']} iterations; {note}")
    say(f"[cli] 64^3 file --mesh 2 ({cards} cards): rc 0, iterations 149, {_structure_line(err)[2:]}; time summary "
        f"{json.dumps(report['Time Summary'])}")


def phase_timing_file_mesh(card: str, stats: dict) -> None:
    """Slope-timed us per CG iteration (legs of 17 and 145) at 4 x 128^3/4
    float32, the 128^3 DIA on 4 ranks of one card: dia-collective (K17, cg
    and cg1), dia-halo (K9 per rank), beside the single-device DIA solve.
    The ranks share one card: these are no scaling numbers. Then K17 (cg)
    against its plain version, plain, kernel, kernel, plain, in float32 and
    float64 (the kernels line's two K17 rows), and the device busy share of
    one 50-iteration K17 solve."""
    from hpccg_tpu_torch import make_cg
    from hpccg_tpu_torch.ops.cuda import collective as col
    from hpccg_tpu_torch.parallel import cg as pcg
    from hpccg_tpu_torch.utils.timing import time_loop_slope

    def slope(run):
        return time_loop_slope(run, device="cuda", short=17, long=145) * 1e6

    mesh = _one_card(FILE_NDEV)
    prob, dia = _explicit_128(torch.float32)
    sp = _sharded_file_problem(dia, mesh, prob.b)
    n = prob.total_nrow
    tag = "4 x 128^3/4 f32 DIA"
    runs = [("dia-collective", "cg"), ("dia-collective", "cg1"), ("dia-halo", "cg")]
    for tier, method in runs:
        last = []

        def run(k, tier=tier, method=method):
            last.append(_file_tier(tier)(mesh, max_iter=k + 1, method=method)(sp.A, sp.b, sp.x0))

        t = slope(run)
        say(f"[timing] {tag} {tier} {method}: {t:.2f} us/iter, {27 * n / t / 1e3:.1f} Gnnz/s (long-leg niters "
            f"{int(last[-1].niters)}; 4 ranks on one card) [{card}]")
    t = slope(lambda k: make_cg(dia, max_iter=k + 1)(prob.b, prob.x0))
    say(f"[timing] 128^3 f32 single-device DIA (K9): {t:.2f} us/iter [{card}]")

    for name, dtype in ((K17, torch.float32), (K17D, torch.float64)):
        prob_t, dia_t = _explicit_128(dtype)
        sp_t = _sharded_file_problem(dia_t, mesh, prob_t.b)

        def plain(k, sp_t=sp_t):
            col.solve_plain_dia(sp_t.A, sp_t.b, sp_t.x0, method="cg", max_iter=k + 1)

        def kernel(k, sp_t=sp_t):
            col.cg_collective_dia(sp_t.A, sp_t.b, sp_t.x0, method="cg", max_iter=k + 1)

        t_p1, t_k1, t_k2, t_p2 = (slope(f) for f in (plain, kernel, kernel, plain))
        st = stats[name]
        st["ms"], st["plain_ms"] = (t_k1 + t_k2) / 2e3, (t_p1 + t_p2) / 2e3
        # one cg iteration: the diagonal data read once and 10 vector passes
        # (p update with x += alpha p folded in 5, apply 2, r update 3); the
        # apply's 2 ndiag operations a row, three axpys and two dots 10
        ndiag, esize = dia_t.ndiag, dia_t.data.element_size()
        _model(st, (ndiag + 10) * n * esize, 2 * ndiag * n + 10 * n, esize)
        bound_ms, _ = _bound(st)
        say(f"[timing] {name} (cg) at 4 x 128^3/4 {str(dtype)[6:]} DIA: {st['ms'] * 1e3:.2f} us/iter vs plain "
            f"{st['plain_ms'] * 1e3:.2f}, bound {bound_ms * 1e3:.2f} ({(ndiag + 10) * n * esize / 1e6:.1f} MB per "
            f"iteration) [{card}]")

    def one(k):
        col.cg_collective_dia(sp.A, sp.b, sp.x0, method="cg", max_iter=k + 1)

    _busy_share(one, EXPLICIT_ITERS, card, f"{tag} K17 cg one {EXPLICIT_ITERS}-iteration solve",
                "collective_dia_kernel")


# ------------------------------------------------------------ slice 6: bench, bf16 K1-K4, the probes

BF16_VEC_ULPS = 4  # kernel vs plain, in bf16 ulps of max|y|
BF16_DOT_RTOL = 1e-3  # the f32 partials, relative
BF16_SHAPE = (256, 256, 256)  # the bf16 main path's size and the shape of its timings
BENCH_KEYS = ("device", "power_limit_w", "backend", "problem", "niters", "cg_iter_us", "spmv_us",
              "spmv_gbps_2pass", "spmv_gnnz_per_s", "cg_iters_per_s", "solve_e2e_s", "mflops_model",
              "final_normr", "hbm_copy_gbps", "hbm_write_gbps", "timing", "other_paths", "vs_baseline_def")
PROBE_ELEMENTS = 1 << 28  # 1 GiB of float32 per array, 20x the L2 (utils/bandwidth.py)


def _bf16_ulps(got, want) -> float:
    """max|got - want| in bf16 ulps of max|want| (2^-7 of its power of 2)."""
    scale = float(want.float().abs().max()) or 1.0
    return float((got.float() - want.float()).abs().max()) / 2.0 ** (math.floor(math.log2(scale)) - 7)


def _bf16_vec(got, want, what) -> float:
    ulps = _bf16_ulps(got, want)
    if not ulps <= BF16_VEC_ULPS:
        raise AssertionError(f"{what}: kernel {ulps:.2f} bf16 ulps of max|y| from plain (limit {BF16_VEC_ULPS})")
    return float((got.float() - want.float()).abs().max())


def _bf16_dot(a, b, what) -> None:
    a, b = float(a), float(b)
    if not abs(a - b) <= BF16_DOT_RTOL * abs(b):
        raise AssertionError(f"{what}: kernel {a!r} vs plain {b!r} (rtol {BF16_DOT_RTOL})")


def _same(a, b, what) -> None:
    if not torch.equal(_bits(a), _bits(b)):
        raise AssertionError(f"{what}: not bit-identical")


def _bf16_cases(op, gen, tag):
    """K1-K4's bf16 instances against their plain versions on random
    inputs, with and without external halo planes (a z-shard): vectors
    within BF16_VEC_ULPS, partials within BF16_DOT_RTOL, p', x', r' bit for
    bit (both round once per operation), two launches bit-identical.
    Returns {kernel: max|kernel - plain|} and the inputs."""
    from hpccg_tpu_torch.ops.cuda import fused_cg as fc
    from hpccg_tpu_torch.ops.cuda import stencil as st

    nx, ny, nz = op.nx, op.ny, op.nz

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    u, r, p, ap = (rnd(nz, ny, nx) for _ in range(4))
    halo2, halo4 = rnd(2, ny, nx), rnd(4, ny, nx)
    beta = torch.tensor([0.37], device="cuda")
    errs = dict.fromkeys((B1, B2, B3, B4), 0.0)
    for halo in (None, halo2):
        what = f"K1/bf16 {tag} halo={halo is not None}"
        y = st.spmv_stencil(op, u, halo)
        errs[B1] = max(errs[B1], _bf16_vec(y, st.spmv_stencil_plain(op, u, halo), what))
        _same(y, st.spmv_stencil(op, u, halo), f"{what} repeat")
        y, parts = st.spmv_stencil_pap(op, u, halo)
        y0, parts0 = st.spmv_stencil_pap_plain(op, u, halo)
        errs[B2] = max(errs[B2], _bf16_vec(y, y0, f"K2/bf16 y {tag}"))
        _bf16_dot(parts.sum(), parts0.sum(), f"K2/bf16 p.Ap {tag}")
        _same(parts, st.spmv_stencil_pap(op, u, halo)[1], f"K2/bf16 {tag} repeat")
    for halo in (None, halo4):
        what = f"K3/bf16 {tag} halo={halo is not None}"
        pp, app, parts = st.update_p_apply(op, r, p, beta, halo)
        pp0, app0, parts0 = st.update_p_apply_plain(op, r, p, beta, halo)
        _same(pp, pp0, f"{what} p' against plain")
        errs[B3] = max(errs[B3], _bf16_vec(app, app0, f"{what} Ap'"))
        _bf16_dot(parts.sum(), parts0.sum(), f"{what} p'.Ap'")
        _same(app, st.update_p_apply(op, r, p, beta, halo)[1], f"{what} repeat")
    alpha = torch.tensor([0.21], device="cuda")
    x1, r1, x2, r2 = u.clone(), r.clone(), u.clone(), r.clone()
    _, _, parts = fc.update_x_r(x1, r1, p, ap, alpha)
    _, _, parts0 = fc.update_x_r_plain(x2, r2, p, ap, alpha)
    _same(x1, x2, f"K4/bf16 x' {tag}")
    _same(r1, r2, f"K4/bf16 r' {tag}")
    _bf16_dot(parts.sum(), parts0.sum(), f"K4/bf16 r'.r' {tag}")
    return errs, (u, r, p, ap, beta, alpha)


def phase_bf16_kernels() -> dict:
    """K1-K4's bf16 instances against their plain versions at SHAPES, 27-
    and 7-point, and at BF16_SHAPE; then their device time per launch at
    BF16_SHAPE 27-point (plain, kernel, kernel, plain) and conv3d in bf16
    beside K1. Returns the bf16 rows' max_abs_err (at BF16_SHAPE), ms,
    plain_ms, library_ms and work model."""
    from hpccg_tpu_torch.config import Stencil
    from hpccg_tpu_torch.operators import StencilOperator
    from hpccg_tpu_torch.ops.cuda import fused_cg as fc
    from hpccg_tpu_torch.ops.cuda import stencil as st

    gen = torch.Generator(device="cuda").manual_seed(4321)
    for nx, ny, nz in SHAPES:
        for stencil in (Stencil.S27, Stencil.S7):
            tag = f"{nx}x{ny}x{nz} {stencil.value}pt bf16"
            errs, _ = _bf16_cases(StencilOperator(nx, ny, nz, stencil, torch.bfloat16), gen, tag)
            say(f"[bf16] {tag}: ok, p' x' r' bit for bit, repeats bit-identical; "
                + " ".join(f"{n.split()[0]}={e:.2e}" for n, e in errs.items()))
    op = StencilOperator(*BF16_SHAPE, Stencil.S27, torch.bfloat16)
    errs, (u, r, p, ap, beta, alpha) = _bf16_cases(op, gen, "256^3 27pt bf16")
    stats = {name: {"max_abs_err": errs[name]} for name in (B1, B2, B3, B4)}
    out, out2 = torch.empty_like(u), torch.empty_like(u)
    parts3 = torch.empty((st.num_partials(op, u.device),), device="cuda")
    parts4 = torch.empty((fc.num_update_partials(u.numel(), u.device),), device="cuda")
    zero = torch.zeros((1,), device="cuda")  # keeps x, r unchanged
    x, rr = u.clone(), r.clone()
    pairs = {
        B1: (lambda: st.spmv_stencil(op, u, out=out), lambda: st.spmv_stencil_plain(op, u, out=out)),
        B2: (lambda: st.spmv_stencil_pap(op, u, out=out, partials=parts3),
             lambda: st.spmv_stencil_pap_plain(op, u, out=out)),
        B3: (lambda: st.update_p_apply(op, r, p, beta, out_p=out, out_ap=out2, partials=parts3),
             lambda: st.update_p_apply_plain(op, r, p, beta, out_p=out, out_ap=out2)),
        B4: (lambda: fc.update_x_r(x, rr, p, ap, zero, partials=parts4),
             lambda: fc.update_x_r_plain(x, rr, p, ap, zero)),
    }
    for name, (kern, plain) in pairs.items():
        _time_pair(stats[name], kern, plain)
    n, nnz = op.local_nrow, op.nnz
    # bytes at 2 per element; the arithmetic is f32 (PEAK_OPS_PER_S[2])
    _model(stats[B1], 2 * n * 2, 2 * nnz, 2)
    _model(stats[B2], 2 * n * 2, 2 * nnz + 2 * n, 2)
    _model(stats[B3], 4 * n * 2, 2 * nnz + 4 * n, 2)
    _model(stats[B4], 6 * n * 2, 6 * n, 2)
    weight, u5 = _conv_weight(op), u.view(1, 1, *u.shape)
    stats[B1]["library_ms"] = _event_ms(lambda: torch.nn.functional.conv3d(u5, weight, padding=1))
    for name in pairs:
        stat = stats[name]
        bound_ms, _ = _bound(stat)
        say(f"[bf16] {name} at 256^3: {stat['ms'] * 1e3:.2f} us vs plain {stat['plain_ms'] * 1e3:.2f}, bound "
            f"{bound_ms * 1e3:.2f} ({stat['bytes'] / 1e6:.1f} MB; {_gbs(stat['bytes'], stat['ms']):.0f} GB/s)"
            + (f", conv3d bf16 {stat['library_ms'] * 1e3:.2f}" if "library_ms" in stat else ""))
    return stats


def phase_probes(card: str) -> dict:
    """The copy and write probe kernels against their plain versions (x + 1;
    seed.repeat(...) * 1.00001) bit for bit, at 1 GiB per array and on
    lengths with a tail past the last whole float4, and against the
    library calls that compute the same (torch.add(x, 1, out=y);
    torch.mul(seed.expand(...), 1.00001, out=o)); then device ms per launch
    of each (plain, kernel, kernel, plain; CUDA events, each launch
    streams >= 1 GiB) with the rates they give."""
    from hpccg_tpu_torch.ops.cuda import stream

    n = PROBE_ELEMENTS
    gen = torch.Generator(device="cuda").manual_seed(99)
    for m in (1, 7, 4096 * 33 + 3):
        x = torch.randn((m,), generator=gen, device="cuda")
        _same(stream.copy_plus_one(x), stream.copy_plus_one_plain(x), f"copy probe n={m}")
    seed = torch.randn((512, 128), generator=gen, device="cuda")
    for m in (4, 65536 * 3 + 5, 1000003):
        _same(stream.write_tiled(seed, m), stream.write_tiled_plain(seed, m), f"write probe n={m}")
    x = torch.randn((n,), generator=gen, device="cuda")
    y, lib = torch.empty_like(x), torch.empty_like(x)
    stream.copy_plus_one(x, out=y)
    _same(y, stream.copy_plus_one_plain(x), "copy probe 1 GiB against plain")
    _same(y, torch.add(x, 1, out=lib), "copy probe 1 GiB against torch.add")
    stats = {COPY: {"max_abs_err": float((y - stream.copy_plus_one_plain(x)).abs().max())}}
    o = stream.write_tiled(seed, n)
    tiles = lib.view(n // seed.numel(), seed.numel())
    torch.mul(seed.reshape(1, -1).expand_as(tiles), 1.00001, out=tiles)
    _same(o, stream.write_tiled_plain(seed, n), "write probe 1 GiB against plain")
    _same(o, lib, "write probe 1 GiB against torch.mul")
    stats[WRITE] = {"max_abs_err": float((o - stream.write_tiled_plain(seed, n)).abs().max())}
    del o
    runs = {
        COPY: (lambda: stream.copy_plus_one(x, out=y), lambda: stream.copy_plus_one_plain(x),
               lambda: torch.add(x, 1, out=lib)),
        WRITE: (lambda: stream.write_tiled(seed, n, out=y), lambda: stream.write_tiled_plain(seed, n),
                lambda: torch.mul(seed.reshape(1, -1).expand_as(tiles), 1.00001, out=tiles)),
    }
    for name, (kern, plain, library) in runs.items():
        stat = stats[name]
        t_p1, t_k1, t_k2, t_p2 = (_event_ms(f) for f in (plain, kern, kern, plain))
        stat.update(ms=(t_k1 + t_k2) / 2, plain_ms=(t_p1 + t_p2) / 2, library_ms=_event_ms(library))
        moved = 2 * 4 * n if name == COPY else 4 * n + 4 * seed.numel()
        _model(stat, moved, n, 4)
        say(f"[probes] {name}: bit for bit against plain and library; {stat['ms'] * 1e3:.1f} us per launch "
            f"({_gbs(moved, stat['ms']):.0f} GB/s) vs plain {stat['plain_ms'] * 1e3:.1f}, library "
            f"{stat['library_ms'] * 1e3:.1f} ({_gbs(moved, stat['library_ms']):.0f} GB/s), bound "
            f"{_bound(stat)[0] * 1e3:.1f} [{card}]")
    return stats


def _bench_line(text: str, what: str, max_iter: int) -> dict:
    """The bench's one JSON line, checked: the JAX bench's keys and the
    port's, niters == max_iter - 1, a finite value > 0."""
    lines = [ln for ln in text.splitlines() if ln.strip()]
    if len(lines) != 1:
        raise AssertionError(f"bench {what}: expected one line, got {len(lines)}: {text[-2000:]}")
    line = json.loads(lines[0])
    missing = [k for k in ("metric", "value", "unit", "vs_baseline") if k not in line]
    missing += [k for k in BENCH_KEYS if k not in line.get("extras", {})]
    if missing:
        raise AssertionError(f"bench {what}: keys missing {missing}")
    ex = line["extras"]
    if ex["niters"] != max_iter - 1 or not (math.isfinite(line["value"]) and line["value"] > 0):
        raise AssertionError(f"bench {what}: niters {ex['niters']}, value {line['value']}")
    if not (math.isfinite(line["vs_baseline"]) and line["vs_baseline"] > 0 and ex["hbm_copy_gbps"] > 0):
        raise AssertionError(f"bench {what}: vs_baseline {line['vs_baseline']}, copy {ex['hbm_copy_gbps']}")
    say(f"[bench] {what}: {lines[0]}")
    return line


@contextlib.contextmanager
def _plain_kernels():
    """The solver's K1-K4 wrappers swapped for their plain versions, which
    run on the card's tensors too: make_cg then runs the same recurrence,
    with the same rounding points, with no kernel of K1-K4. The plain
    versions' partials land in the first slot of the kernels' partial
    arrays (the rest zero), so the finalize step sums what it would."""
    from unittest import mock

    from hpccg_tpu_torch.ops.cuda import fused_cg as fc
    from hpccg_tpu_torch.ops.cuda import stencil as st

    def into(partials, part):
        if partials is None:
            return part
        partials.zero_()
        partials[:1].copy_(part)
        return partials

    def k2(op, u, halo=None, *, out=None, partials=None, active=None):
        y, part = st.spmv_stencil_pap_plain(op, u, halo, out=out, active=active)
        return y, into(partials, part)

    def k3(op, r, p, beta, halo=None, *, out_p=None, out_ap=None, partials=None, active=None, store_ap=True):
        pp, ap, part = st.update_p_apply_plain(op, r, p, beta, halo, out_p=out_p, out_ap=out_ap, active=active,
                                               store_ap=store_ap)
        return pp, ap, into(partials, part)

    def k4(x, r, p, ap, alpha, *, partials=None, active=None):
        x, r, part = fc.update_x_r_plain(x, r, p, ap, alpha, active=active)
        return x, r, into(partials, part)

    def k4s(op, x, r, p, alpha, *, partials=None, active=None):
        x, r, part = st.update_x_r_stencil_plain(op, x, r, p, alpha, active=active)
        return x, r, into(partials, part)

    with mock.patch.multiple("hpccg_tpu_torch.solver", spmv_stencil=st.spmv_stencil_plain, spmv_stencil_pap=k2,
                             update_p_apply=k3, update_x_r=k4, update_x_r_stencil=k4s):
        yield


def _main_path_slice6() -> None:
    """The bf16 main path at BF16_SHAPE (max_iter 50): make_cg on pallas (K1,
    K2 bf16) and pallas_fused (K1, K3 without its Ap' store and K4s bf16:
    one launch each per iteration), each held against the same recurrence with the plain versions
    in place of the kernels (WS_TRACE bf16, as K5/K6 against theirs), and,
    as the bf16 whole solves are, against the float32 stencil trace and the
    bf16 streamkernel trace (BF16_RTOL above BF16_FLOOR: two bf16
    recurrences that round at other places part by percents; K6 never
    stores Ap'); make_distributed_cg in bf16 on auto (= pallas: K2 with bf16
    halo planes) on 4 ranks of the card at 64x64x64 per rank, against the
    single-device pallas solve of the same grid; then the benchmark entry
    point in process, ``--preset strong256 --dtype bfloat16 --backend
    pallas_fused``, which runs K1/K3/K4s bf16 and both probe kernels.
    K3/K4 bf16 with the Ap' store are counted on _main_path_slice6_fused."""
    from hpccg_tpu_torch import ProblemConfig, generate_problem, make_cg
    from hpccg_tpu_torch import bench
    from hpccg_tpu_torch.parallel import generate_problem_sharded, make_distributed_cg

    runs = _solve_all(BF16_SHAPE, 50, ["streamkernel", "pallas", "pallas_fused"], torch.bfloat16)
    f32 = _solve_all(BF16_SHAPE, 50, ["stencil"])["stencil"][0]
    prob = generate_problem(ProblemConfig(*BF16_SHAPE, stencil=27, dtype=torch.bfloat16), "cuda")
    rtol, floor = WS_TRACE[torch.bfloat16]
    for backend in ("pallas", "pallas_fused"):
        tr, delta, res = runs[backend]
        if res.x.dtype != torch.bfloat16 or res.trace.dtype != torch.float32:
            raise AssertionError(f"bf16 {backend}: x {res.x.dtype}, trace {res.trace.dtype}")
        with _plain_kernels():
            want = make_cg(prob.A, max_iter=50, tolerance=0.0, backend=backend)(prob.b, prob.x0)
        worst, tail = _trace_check(tr, want.trace.double().cpu(), f"256^3 bf16 {backend} vs plain", rtol, floor)
        cross = [_head_rel(tr, ref, BF16_RTOL, BF16_FLOOR, f"256^3 bf16 {backend} vs {what}")
                 for what, ref in (("float32 stencil", f32), ("bf16 streamkernel", runs["streamkernel"][0]))]
        xerr, share = float((res.x.float() - want.x.float()).abs().max()), float((res.x != want.x).double().mean())
        say(f"[main] 256^3 bf16 {backend}: trace within {worst:.2e} of its plain version's above {floor} of "
            f"trace[0] ({tail:.2e} below), x within {xerr:.2e} of it in {share:.2e} of the elements; within "
            f"{cross[0]:.2e} of the float32 stencil trace and {cross[1]:.2e} of the bf16 streamkernel trace "
            f"above {BF16_FLOOR}; max|x - 1| {float((res.x.float() - 1).abs().max()):.3e}")
    fused = runs["pallas_fused"][1]
    if not (fused[B3] == fused[K4S] == 49 and fused[B4] == 0 and fused[B1] >= 1):
        raise AssertionError(f"256^3 bf16 pallas_fused: expected K3/K4s bf16 once per iteration: {fused}")
    if runs["pallas"][1][B2] < 49:
        raise AssertionError(f"256^3 bf16 pallas: K2 bf16 launched {runs['pallas'][1][B2]} times")
    cfg = ProblemConfig(64, 64, 64, dtype=torch.bfloat16)
    mesh = _one_card(4)
    prob = generate_problem_sharded(cfg, mesh)
    before = _counts()
    res = make_distributed_cg(cfg, mesh, max_iter=50, tolerance=0.0)(prob.b, prob.x0)
    torch.cuda.synchronize()
    delta = {n: c - before[n] for n, c in _counts().items()}
    gprob = generate_problem(ProblemConfig(64, 64, 256, dtype=torch.bfloat16), "cuda")
    single = make_cg(gprob.A, max_iter=50, tolerance=0.0, backend="pallas")(gprob.b, gprob.x0)
    if int(res.niters) != 49 or delta[B2] < 4 * 49 or not bool(torch.isfinite(torch.cat(res.x).float()).all()):
        raise AssertionError(f"4 x 64^3 bf16 auto: niters {int(res.niters)}, launches {delta}")
    # the same stencil sums and p.Ap partials in the same order; r.r is
    # summed per rank, in another order
    worst, tail = _trace_check(res.trace.double().cpu(), single.trace.double().cpu(),
                               "4 x 64^3 bf16 auto vs single-device pallas", rtol, floor)
    say(f"[main] 4 x 64^3 bf16 distributed auto (pallas, K2 bf16 with halo planes): niters 49, trace within "
        f"{worst:.2e} of the single-device pallas solve's, {tail:.2e} below; launches {_launch_note(delta)}")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = bench.main(["--preset", "strong256", "--dtype", "bfloat16", "--backend", "pallas_fused"])
    if rc != 0:
        raise AssertionError(f"bench strong256 bf16 pallas_fused returned {rc}")
    _bench_line(buf.getvalue(), "--preset strong256 --dtype bfloat16 --backend pallas_fused (in process)", 150)


def _bf16_fused_reference():
    """The single-device bf16 pallas_fused trace of the 64x64x256 grid
    (K3 without its Ap' store and K4s), that _main_path_slice6_fused is
    held against; solved outside its drive, so that its launches are not
    counted as that path's."""
    from hpccg_tpu_torch import ProblemConfig, generate_problem, make_cg

    gprob = generate_problem(ProblemConfig(64, 64, 256, dtype=torch.bfloat16), "cuda")
    return make_cg(gprob.A, max_iter=50, tolerance=0.0, backend="pallas_fused")(gprob.b, gprob.x0).trace


def _main_path_slice6_fused(single) -> None:
    """K3/bf16 with its Ap' store and K4/bf16 on their main path:
    make_distributed_cg in bf16 on pallas_fused (K3 with bf16 halo planes,
    then K4, on every rank) on 4 ranks of the card at 64x64x64 per rank,
    max_iter 50, against the single-device pallas_fused trace ``single``
    of the same grid (_bf16_fused_reference) within BF16_RTOL above
    BF16_FLOOR; no K3 without the Ap' store and no K4s."""
    from hpccg_tpu_torch import ProblemConfig
    from hpccg_tpu_torch.parallel import generate_problem_sharded, make_distributed_cg

    cfg = ProblemConfig(64, 64, 64, dtype=torch.bfloat16)
    mesh = _one_card(4)
    prob = generate_problem_sharded(cfg, mesh)
    before = _counts()
    res = make_distributed_cg(cfg, mesh, max_iter=50, tolerance=0.0, backend="pallas_fused")(prob.b, prob.x0)
    torch.cuda.synchronize()
    delta = {n: c - before[n] for n, c in _counts().items()}
    if int(res.niters) != 49 or delta[B3] != 4 * 49 or delta[B4] != 4 * 49 or delta[K3N] or delta[K4S]:
        raise AssertionError(f"4 x 64^3 bf16 pallas_fused: niters {int(res.niters)}, launches {delta}")
    worst = _head_rel(res.trace.double().cpu(), single.double().cpu(), BF16_RTOL, BF16_FLOOR,
                      "4 x 64^3 bf16 pallas_fused vs single-device pallas_fused")
    say(f"[main] 4 x 64^3 bf16 distributed pallas_fused (K3/K4 bf16 with halo planes): niters 49, trace within "
        f"{worst:.2e} of the single-device pallas_fused solve's above {BF16_FLOOR}; launches {_launch_note(delta)}")


def phase_bench() -> None:
    """``python -m hpccg_tpu_torch.bench --preset headline100`` and
    ``--preset strong256`` as subprocesses (the bf16 run is the main path's,
    in process): each prints one JSON line with the keys, niters 149 and a
    finite value."""
    root = os.path.dirname(os.path.abspath(__file__))
    for preset in ("headline100", "strong256"):
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "hpccg_tpu_torch.bench", "--preset", preset],
                              capture_output=True, text=True, cwd=root, timeout=600)
        if proc.returncode != 0:
            raise AssertionError(f"bench --preset {preset} returned {proc.returncode}: {proc.stderr[-3000:]}")
        _bench_line(proc.stdout, f"--preset {preset} ({time.perf_counter() - t0:.1f} s)", 150)


# ------------------------------------------------------------ slice 7: bf16 on K15/K16 and in file mode

COLL_BF16_NDEVS = [1, 2, 4, 8]
BF16_FILE_ITERS = 50  # the bf16 file and collective main paths: where both sides stagnate at tolerance 0
# the main path's collective bf16 cells: the headline unit and 64^3 per rank on 4 and 8 ranks of one card
BF16_COLL_CELLS = [("1 x 100^3", 1, (100, 100, 100)), ("4 x 64^3", 4, (64, 64, 64)), ("8 x 64^3", 8, (64, 64, 64))]
# bf16 pipecg (K16/bf16) against its plain version: its w and z recurrences
# carry each run's rounding forward, and in bf16 it diverges in both
# packages (the JAX package's x lies 0.14-1.3 from ones at its test sizes).
# On the CPU two runs of the plain version whose dots sum in another order
# (float64; scripts/bf16_pipecg_sum_order.py) part by 1.5e-2 from k = 9-16
# at 1-8 ranks of 33x17x9 to 64^3; at 8 x 128x64x16 they differ by 4.7e-3
# in the trace and in 74% of x's elements after 8 iterations, and at 64^3
# the true residual after 50 iterations is 9.8 (x0's is 1). On an H100 the
# kernel and its plain version give the same x through 5 iterations at every
# shape here, and part at the 6th at 8 x 33x17x9 (1 ulp in 9.11e-3 of x).
# So K16/bf16 is held whole (the trace, and x as _x_check holds it) on
# solves of PIPE_BF16_HEAD iterations, and a longer solve over its first
# PIPE_BF16_HEAD trace entries with x finite.
PIPE_BF16_HEAD = 5
# Runs of 50 iterations that sum the dots in another order: the same script
# parts cg1 at 64^3 by 1.5e-2 at k = 24, where the trace is 5.5e-4 of
# trace[0]. The main path's traces are held above BF16_MAIN_FLOOR of trace[0].
BF16_MAIN_FLOOR = 1e-3


def _bf16_held(res, plain, method, what, floor) -> str:
    """A bf16 solve against its plain version's: niters equal, the trace
    within WS_TRACE's bf16 rtol above floor * trace[0] and x as _x_check
    holds bf16; a pipecg solve longer than PIPE_BF16_HEAD iterations over
    its first PIPE_BF16_HEAD trace entries, with x finite. Returns the
    note."""
    if int(res.niters) != int(plain.niters) or res.trace.dtype != torch.float32:
        raise AssertionError(f"{what}: niters {int(res.niters)} vs plain {int(plain.niters)}, trace {res.trace.dtype}")
    head = method == "pipecg" and int(plain.niters) + 1 > PIPE_BF16_HEAD
    n = PIPE_BF16_HEAD if head else int(plain.niters) + 1
    worst = _head_rel(res.trace[:n].double().cpu(), plain.trace[:n].double().cpu(), WS_TRACE[torch.bfloat16][0],
                      floor, what)
    gx = torch.cat(res.x) if isinstance(res.x, tuple) else res.x
    wx = torch.cat(plain.x) if isinstance(plain.x, tuple) else plain.x
    if not bool(torch.isfinite(gx).all()):
        raise AssertionError(f"{what}: x is not finite")
    share = float((gx != wx).double().mean())
    note = f"trace within {worst:.2e} of plain over {n} entries above {floor} of trace[0]; "
    if head:
        return note + (f"x {_ulps(gx, wx)} ulps from plain's in {share:.2e} of the elements, max|x - 1| "
                       f"{float((gx.float() - 1).abs().max()):.3e}")
    _x_check(gx, wx, what)
    return note + f"x {_ulps(gx, wx)} ulps in {share:.2e} of the elements"


def _bf16_dia(D):
    """DiaMatrix D with its data in bf16."""
    return dataclasses.replace(D, data=D.data.to(torch.bfloat16))


def phase_bf16_sparse_kernels(card: str) -> dict:
    """K9/bf16 and K11/bf16 against their plain versions, bit for bit, on the
    matrices of phase_sparse_kernels in bf16 (the stencil at 100^3 and
    128^3, a 1000-diagonal band; for ELL also the permuted 64^3 stencil as
    loaded and after RCM, a wide scatter and a skewed matrix), two launches
    bit-identical; K9/bf16's window instance (dia-halo) on each rank's
    extended vector of the 128^3 DIA on 4 ranks, and K11/bf16 on each rank's
    rows of the 128^3 ELL on 4 ranks (ell-halo's extended vector,
    ell-allgather's global x). Device time per launch (plain, kernel,
    kernel, plain) at 128^3 (the window instance per rank at 4 x 128^3/4),
    the byte models' GB/s, and CSR torch.mv in bf16 of the same rows where
    the library has it."""
    from hpccg_tpu_torch.ops.cuda import dia as cdia
    from hpccg_tpu_torch.ops.cuda import ell as cell
    from hpccg_tpu_torch.parallel import cg as pcg
    from hpccg_tpu_torch.reorder import permute_ell, rcm_permutation

    bf = torch.bfloat16
    stats = {name: {"max_abs_err": 0.0} for name in (D9, D9W, E11)}
    gen = torch.Generator(device="cuda").manual_seed(2025)
    perm64, _ = _permuted(_stencil_ell((64, 64, 64), torch.float64, "cpu"), 1)
    rcm64 = permute_ell(perm64.A, rcm_permutation(perm64.A))

    def library(st, A, x):
        csr = _csr(A)
        try:
            st["library_ms"] = _event_ms(lambda: torch.mv(csr, x))
        except RuntimeError as err:  # no bf16 CSR product in this torch build: no library time
            say(f"[bf16-sparse] CSR torch.mv in bf16: {str(err).splitlines()[0][:120]}")

    dia_cases = [("100^3 stencil", _bf16_dia(_stencil_ell((100,) * 3, torch.float32).A.to_dia())),
                 ("128^3 stencil", _bf16_dia(_explicit_128(torch.float32)[1])),
                 ("1000-diagonal band n=1000003", _random_band(1_000_003, 1000, 4000, bf, gen))]
    for tag, D in dia_cases:
        P = cdia.prepare_dia(D)
        x = torch.randn(D.local_nrow, generator=gen, device="cuda").to(bf)
        out = torch.empty_like(x)
        what = f"K9/bf16 {tag}"
        err = _sparse_pair(lambda: cdia.spmv_dia(P, x), lambda: cdia.spmv_dia_plain(P, x), bf, what, True)
        stats[D9]["max_abs_err"] = max(stats[D9]["max_abs_err"], err)
        st = stats[D9] if tag.startswith("128") else {}
        _time_pair(st, lambda: cdia.spmv_dia(P, x, out=out), lambda: cdia.spmv_dia_plain(P, x, out=out))
        nbytes = _dia_bytes(D)
        if tag.startswith("128"):
            _model(st, nbytes, 2 * _explicit_128(torch.float32)[0].A.nnz, 2)
            library(st, _cast(_explicit_128(torch.float32)[0].A, bf), x)
        say(f"[bf16-sparse] {what}: ok, bit for bit; {D.ndiag} diagonals; {st['ms'] * 1e3:.1f} us vs plain "
            f"{st['plain_ms'] * 1e3:.1f} ({_gbs(nbytes, st['ms']):.0f} GB/s of {nbytes / 1e6:.0f} MB) [{card}]")
    # the window instance: each rank's DiaRows on its extended vector (4 x 128^3/4)
    D = _bf16_dia(_explicit_128(torch.float32)[1])
    mesh = _one_card(FILE_NDEV)
    blocks = pcg.shard_matrix(D, mesh)
    tier = pcg.HaloTier(blocks, mesh.devices, "dia-halo")
    x = torch.randn(D.local_nrow, generator=gen, device="cuda").to(bf)
    exts = tier.strips.fill(mesh.shard(x))
    for r, ((P, _), ext) in enumerate(zip(tier.kernels, exts)):
        err = _sparse_pair(lambda: cdia.spmv_dia(P, ext), lambda: cdia.spmv_dia_plain(P, ext), bf,
                           f"K9/bf16 window rank {r} of 4 x 128^3/4", True)
        stats[D9W]["max_abs_err"] = max(stats[D9W]["max_abs_err"], err)
    if not torch.equal(_bits(torch.cat(tier.apply(exts))), _bits(cdia.spmv_dia(cdia.prepare_dia(D), x))):
        raise AssertionError("K9/bf16 window: the 4 ranks' product differs from the single-device K9/bf16's")
    P, ext = tier.kernels[1][0], exts[1]
    out = torch.empty((P.A.local_nrow,), dtype=bf, device="cuda")
    st = stats[D9W]
    _time_pair(st, lambda: cdia.spmv_dia(P, ext, out=out), lambda: cdia.spmv_dia_plain(P, ext, out=out))
    L = P.A.local_nrow
    nbytes = P.A.ndiag * L * 2 + (P.xlen + L) * 2
    _model(st, nbytes, 2 * P.A.ndiag * L, 2)
    # the library's product of the same rows: rank 1's rows as CSR over its extended vector
    E = _cast(_explicit_128(torch.float32)[0].A, bf)
    library(st, pcg.ell_window(pcg.shard_matrix(E, mesh)[1], P.lo, P.hi), ext)
    say(f"[bf16-sparse] K9/bf16 window, 4 x 128^3/4 (band {P.lo}/{P.hi}): ok, bit for bit on every rank and "
        f"equal to the single-device product; rank 1 {st['ms'] * 1e3:.1f} us vs plain {st['plain_ms'] * 1e3:.1f} "
        f"({_gbs(nbytes, st['ms']):.0f} GB/s of {nbytes / 1e6:.0f} MB) [{card}]")
    ell_cases = [("100^3 stencil", _cast(_stencil_ell((100,) * 3, torch.float32).A, bf)),
                 ("128^3 stencil", _cast(_explicit_128(torch.float32)[0].A, bf)),
                 ("permuted 64^3 stencil as loaded", _cast(perm64.A, bf)),
                 ("permuted 64^3 stencil after RCM", _cast(rcm64, bf)),
                 ("wide scatter n=10^6", _wide_scatter(1_000_000, 9, 300_000, bf, gen)),
                 ("skewed 100^3 (one row of 240 slots)", _skewed(_cast(_stencil_ell((100,) * 3, torch.float32).A,
                                                                        bf)))]
    for tag, A in ell_cases:
        S = cell.prepare_ell(A)
        x = torch.randn(A.local_nrow, generator=gen, device="cuda").to(bf)
        out = torch.empty_like(x)
        what = f"K11/bf16 {tag}"
        err = _sparse_pair(lambda: cell.spmv_ell(S, x), lambda: cell.spmv_ell_plain(S, x), bf, what, True)
        stats[E11]["max_abs_err"] = max(stats[E11]["max_abs_err"], err)
        st = stats[E11] if tag.startswith("128") else {}
        _time_pair(st, lambda: cell.spmv_ell(S, x, out=out), lambda: cell.spmv_ell_plain(S, x, out=out))
        nbytes = _ell_bytes(S)
        if tag.startswith("128"):
            _model(st, nbytes, 2 * A.nnz, 2)
            library(st, A, x)
        say(f"[bf16-sparse] {what}: ok, bit for bit; width {S.width}; {st['ms'] * 1e3:.1f} us vs plain "
            f"{st['plain_ms'] * 1e3:.1f} ({_gbs(nbytes, st['ms']):.0f} GB/s of {nbytes / 1e6:.0f} MB) [{card}]")
    # the tiers' shapes (4 x 128^3/4): each rank's L rows on its extended vector (ell-halo) and on the global x
    # (ell-allgather); the ranks' rows give the single-device product
    x = torch.randn(E.local_nrow, generator=gen, device="cuda").to(bf)
    whole = cell.spmv_ell(cell.prepare_ell(E), x)
    blocks = pcg.shard_matrix(E, mesh)
    halo = pcg.HaloTier(blocks, mesh.devices, "ell-halo")
    for tier, pairs in (("ell-halo", zip((S for S, _ in halo.kernels), halo.strips.fill(mesh.shard(x)))),
                        ("ell-allgather", ((cell.prepare_ell(blk), x) for blk in blocks))):
        ys = []
        for r, (S, v) in enumerate(pairs):
            err = _sparse_pair(lambda: cell.spmv_ell(S, v), lambda: cell.spmv_ell_plain(S, v), bf,
                               f"K11/bf16 {tier} rank {r} of 4 x 128^3/4 ({S.width} slots over {v.numel()} columns)",
                               True)
            stats[E11]["max_abs_err"] = max(stats[E11]["max_abs_err"], err)
            ys.append(cell.spmv_ell(S, v))
        if not torch.equal(_bits(torch.cat(ys)), _bits(whole)):
            raise AssertionError(f"K11/bf16 {tier}: the 4 ranks' product differs from the single-device K11/bf16's")
        say(f"[bf16-sparse] K11/bf16 {tier}, 4 x 128^3/4: ok, bit for bit on every rank and equal to the "
            "single-device product")
    for name in (D9, D9W, E11):
        st = stats[name]
        say(f"[bf16-sparse] {name}: {st['ms'] * 1e3:.2f} us per launch, bound {_bound(st)[0] * 1e3:.2f}, plain "
            f"{st['plain_ms'] * 1e3:.2f}, library "
            + (f"{st['library_ms'] * 1e3:.2f}" if st.get("library_ms") is not None else "none") + f" [{card}]")
    return stats


def phase_collective_bf16_kernels() -> dict:
    """K15/bf16 (cg, cg1) and K16/bf16 (pipecg) against their plain
    versions (the same split: bf16 vectors, float32 scalars) with every
    rank on cuda:0, as _bf16_held holds them, two launches bit-identical: at
    1, 2, 4 and 8 ranks, per rank 33x17x9 (27- and 7-point), 64x48x13,
    128x64x16 and COLL_MULTI, and at the staged tile's edges and on b/x0
    views at odd offsets (_coll_edge_cases), COLL_ITERS iterations (a solve stops at WS_TRACE's bf16
    floor, on a tolerance between two of the plain trace's entries, where
    the trace reaches it) and pipecg also PIPE_BF16_HEAD iterations; then
    pipecg at the main path's shapes (BF16_COLL_CELLS), PIPE_BF16_HEAD
    iterations. Returns max|x - x_plain| of each over the solves whose x is
    held."""
    from hpccg_tpu_torch import ProblemConfig
    from hpccg_tpu_torch.ops.cuda import collective as col
    from hpccg_tpu_torch.parallel import generate_problem_sharded
    from hpccg_tpu_torch.parallel.cg import local_operator

    bf = torch.bfloat16
    stats = {name: {"max_abs_err": 0.0} for name in (C15, C16)}
    floor = WS_TRACE[bf][1]

    def held(op, prob, method, iters, tag):
        name = C16 if method == "pipecg" else C15
        what = f"{name.split()[0]} {method} {iters} iterations {tag}"
        want = col.solve_plain(op, prob.b, prob.x0, method=method, max_iter=iters)
        tol = _ws_tolerance(want.trace, floor)
        if tol:
            want = col.solve_plain(op, prob.b, prob.x0, method=method, max_iter=iters, tolerance=tol)
        kern = _coll_kernel(method)
        got, again = (kern(op, prob.b, prob.x0, max_iter=iters, tolerance=tol) for _ in range(2))
        torch.cuda.synchronize()
        note = _bf16_held(got, want, method, what, floor)
        same = all(torch.equal(_bits(a), _bits(b)) for a, b in zip(got.x, again.x))
        if not (same and torch.equal(_bits(got.trace), _bits(again.trace))):
            raise AssertionError(f"{what}: two launches differ")
        if method != "pipecg" or iters <= PIPE_BF16_HEAD:
            err = float((torch.cat(got.x).float() - torch.cat(want.x).float()).abs().max())
            stats[name]["max_abs_err"] = max(stats[name]["max_abs_err"], err)
        return f"{method} {iters} iterations: niters {int(got.niters)}, {note}"

    runs = [("cg", COLL_ITERS), ("cg1", COLL_ITERS), ("pipecg", PIPE_BF16_HEAD), ("pipecg", COLL_ITERS)]
    for ndev in COLL_BF16_NDEVS:
        mesh = _one_card(ndev)
        for dims in COLL_SHAPES:
            for stencil in (27, 7) if dims == COLL_SHAPES[0] else (27,):
                cfg = ProblemConfig(*dims, stencil=stencil, dtype=bf)
                op, prob = local_operator(cfg), generate_problem_sharded(cfg, mesh)
                tag = f"{ndev} x {dims[0]}x{dims[1]}x{dims[2]} {stencil}pt bf16"
                line = [held(op, prob, method, iters, tag) for method, iters in runs]
                say(f"[collective-bf16] {tag}: ok, bit-identical; " + "; ".join(line))
    for edge, ndev, dims, stencil, offsets in _coll_edge_cases(bf):
        op, prob = _coll_edge_problem(ndev, dims, stencil, bf, offsets)
        tag = f"{edge}: {ndev} x {dims[0]}x{dims[1]}x{dims[2]} {stencil}pt bf16"
        line = [held(op, prob, method, iters, tag) + f" (access {col.launch.access})" for method, iters in runs]
        say(f"[collective-bf16] {tag}: ok, bit-identical; " + "; ".join(line))
    for label, ndev, dims in BF16_COLL_CELLS:
        cfg = ProblemConfig(*dims, dtype=bf)
        op, prob = local_operator(cfg), generate_problem_sharded(cfg, _one_card(ndev))
        note = held(op, prob, "pipecg", PIPE_BF16_HEAD, f"{label} bf16")
        say(f"[collective-bf16] {label} bf16 (the main path's shape): ok, bit-identical; {note}")
    return stats


def _plain_tier(tier, A, mesh):
    """The sharded A v of a file tier (dia-halo, ell-halo, ell-allgather)
    on the rank blocks of A, with each rank's kernel swapped for its plain
    version."""
    from hpccg_tpu_torch.ops.cuda import dia as cdia
    from hpccg_tpu_torch.ops.cuda import ell as cell
    from hpccg_tpu_torch.parallel import cg as pcg

    blocks = pcg.shard_matrix(A, mesh)
    if tier == "ell-allgather":
        slots = [cell.prepare_ell(blk) for blk in blocks]
        return lambda vs: tuple(cell.spmv_ell_plain(S, torch.cat(vs)) for S in slots)
    halo = pcg.HaloTier(blocks, mesh.devices, tier)
    plain = cdia.spmv_dia_plain if tier == "dia-halo" else cell.spmv_ell_plain
    halo.kernels = [(S, plain) for S, _ in halo.kernels]
    return halo


def _main_path_slice7() -> None:
    """bf16 at full width. (a) make_distributed_cg in bf16 on collective
    (cg, cg1, pipecg: one launch of K15/bf16 or K16/bf16 per solve) at 1 x
    100^3, 4 x 64^3 and 8 x 64^3 per rank on one card, BF16_FILE_ITERS
    iterations at tolerance 0, each against its plain version as _bf16_held
    holds it above BF16_MAIN_FLOOR (pipecg over its trace head: it is held
    whole at these shapes in phase_collective_bf16_kernels), cg also
    against the single-device float32 stencil trace (BF16_RTOL above
    BF16_FLOOR); (b) make_cg on
    generate_ell(128^3) in bf16 as DIA and as ELL on auto (K9/bf16 and
    K11/bf16, float32 scalars), each against the same recurrence with the
    plain matvec (the same sums: WS_TRACE bf16, x as _x_check holds it) and
    against the float32 stencil trace; (c) the 128^3 bf16 DIA and ELL on 4
    ranks of one card: dia-halo (K9/bf16's window instance), ell-halo and
    ell-allgather (K11/bf16), each against the same recurrence on the same
    shards with the plain matvecs (_plain_tier), as (b)."""
    from hpccg_tpu_torch import ProblemConfig, generate_problem, make_cg
    from hpccg_tpu_torch.ops.cuda import collective as col
    from hpccg_tpu_torch.ops.cuda import dia as cdia
    from hpccg_tpu_torch.ops.cuda import ell as cell
    from hpccg_tpu_torch.parallel import generate_problem_sharded, make_distributed_cg
    from hpccg_tpu_torch.parallel.cg import local_operator
    from hpccg_tpu_torch.solver import cg_solve

    bf, iters = torch.bfloat16, BF16_FILE_ITERS
    floor = WS_TRACE[bf][1]

    def counted(fn):
        before = _counts()
        res = fn()
        torch.cuda.synchronize()
        return res, {n: c - before[n] for n, c in _counts().items()}

    for label, ndev, dims in BF16_COLL_CELLS:
        cfg = ProblemConfig(*dims, dtype=bf)
        op, mesh = local_operator(cfg), _one_card(ndev)
        prob = generate_problem_sharded(cfg, mesh)
        gprob = generate_problem(ProblemConfig(dims[0], dims[1], dims[2] * ndev, dtype=torch.float32), "cuda")
        f32 = make_cg(gprob.A, max_iter=iters, tolerance=0.0, backend="stencil")(gprob.b, gprob.x0)
        for method in ("cg", "cg1", "pipecg"):
            what = f"{label} bf16 collective {method}"
            res, delta = counted(lambda: make_distributed_cg(cfg, mesh, max_iter=iters, backend="collective",
                                                             method=method)(prob.b, prob.x0))
            kernel = C16 if method == "pipecg" else C15
            # a bf16 launch counts on the wrapper's launches and launches_bf16
            if delta[kernel] != 1 or delta[METHOD_KERNEL[method]] != 1 or _launch_sum(delta) != 2:
                raise AssertionError(f"{what}: expected one launch of {kernel}, got {delta}")
            plain = col.solve_plain(op, prob.b, prob.x0, method=method, max_iter=iters)
            if int(res.niters) != iters - 1:
                raise AssertionError(f"{what}: niters {int(res.niters)}")
            note = _bf16_held(res, plain, method, what, BF16_MAIN_FLOOR)
            note += f"; true residual {_true_residual(op, prob.b, res.x):.3e} (plain {_true_residual(op, prob.b, plain.x):.3e})"
            cross = ""
            if method == "cg":
                c = _head_rel(res.trace.double().cpu(), f32.trace.double().cpu(), BF16_RTOL, BF16_FLOOR,
                              f"{what} vs the float32 stencil")
                cross = f"; {c:.2e} of the f32 stencil trace above {BF16_FLOOR}"
            say(f"[main] {what}: niters {int(res.niters)}; {note}{cross}; launches {_launch_note(delta)}")
    prob32, dia32 = _explicit_128(torch.float32)
    b, x0 = prob32.b.to(bf), prob32.x0.to(bf)
    f32 = _stencil_reference(torch.float32)
    D, E = _bf16_dia(dia32), _cast(prob32.A, bf)
    for fmt, A, kernel, prep, plain_mv in (("DIA", D, D9, cdia.prepare_dia, cdia.spmv_dia_plain),
                                          ("ELL", E, E11, cell.prepare_ell, cell.spmv_ell_plain)):
        what = f"128^3 bf16 {fmt} auto"
        res, delta = counted(lambda: make_cg(A, max_iter=iters, tolerance=0.0)(b, x0))
        if delta[kernel] != iters or int(res.niters) != iters - 1 or res.trace.dtype != torch.float32:
            raise AssertionError(f"{what}: niters {int(res.niters)}, {kernel} launched {delta[kernel]} times")
        P = prep(A)
        want = cg_solve(lambda v: plain_mv(P, v), b, x0, max_iter=iters, scalars=torch.float32)
        note = _bf16_held(res, want, "cg", what, floor)
        c = _head_rel(res.trace.double().cpu(), f32.trace.double().cpu(), BF16_RTOL, BF16_FLOOR,
                      f"{what} vs the float32 stencil")
        say(f"[main] {what}: niters {int(res.niters)}; against the same recurrence on the plain matvec: {note}; "
            f"{c:.2e} of the f32 stencil trace above {BF16_FLOOR}; launches {_launch_note(delta)}")
    mesh = _one_card(FILE_NDEV)
    shards = {"dia": _sharded_file_problem(D, mesh, b), "ell": _sharded_file_problem(E, mesh, b)}
    for tier, kernel in (("dia-halo", D9W), ("ell-halo", E11), ("ell-allgather", E11)):
        what = f"4 x 128^3/4 bf16 {tier}"
        sp = shards["dia" if tier.startswith("dia") else "ell"]
        res, delta = counted(lambda: _file_tier(tier)(mesh, max_iter=iters)(sp.A, sp.b, sp.x0))
        if delta[kernel] != FILE_NDEV * iters or int(res.niters) != iters - 1:
            raise AssertionError(f"{what}: niters {int(res.niters)}, {kernel} launched {delta[kernel]} times")
        want = cg_solve(_plain_tier(tier, sp.A, mesh), sp.b, sp.x0, max_iter=iters, scalars=torch.float32)
        note = _bf16_held(res, want, "cg", what, floor)
        say(f"[main] {what}: niters {int(res.niters)}; against the same recurrence on the plain matvecs: {note}; "
            f"launches {_launch_note(delta)}")


def phase_cli_bf16_files() -> None:
    """File mode in bf16 through the CLI on the card: the 64^3 stencil file
    (dia, K9/bf16) and its randomly permuted twin (ell+rcm, K11/bf16), 149
    iterations each, --check in the file's basis."""
    from hpccg_tpu_torch.io import write_hpc_row
    from hpccg_tpu_torch.ops.cuda import dia as cdia
    from hpccg_tpu_torch.ops.cuda import ell as cell

    prob = _stencil_ell((64, 64, 64), torch.float64, "cpu")
    with tempfile.TemporaryDirectory() as tmp:
        for name, p, want, counter in (("stencil", prob, "dia", (cdia.spmv_dia, "launches_bf16")),
                                       ("permuted", _permuted(prob, 3)[0], "ell+rcm", (cell.spmv_ell, "launches_bf16"))):
            path = os.path.join(tmp, f"{name}64.txt")
            write_hpc_row(path, p)
            before = getattr(*counter)
            report, _, err = _cli([path, "--json", "--dtype", "bfloat16", "--check"], f"64^3 {name} file bf16")
            line = _structure_line(err)
            if (report["Number of iterations"] != 149 or not line.startswith(f"# matrix structure: {want} —")
                    or getattr(*counter) - before < 2 * 150 or not report["Difference between computed and exact"] < 0.1):
                raise AssertionError(f"cli 64^3 {name} bf16: {report['Number of iterations']} iterations; {line}; "
                                     f"{getattr(*counter) - before} launches; check "
                                     f"{report['Difference between computed and exact']}")
            say(f"[cli] 64^3 {name} file --dtype bfloat16: rc 0, iterations 149, {line[2:]}; check "
                f"{report['Difference between computed and exact']:.3e}; time summary "
                f"{json.dumps(report['Time Summary'])}")


def phase_timing_bf16(card: str, stats: dict) -> None:
    """Slope-timed us per iteration: the collective backends in bf16 at 1 x
    100^3 (beside float32, legs of 17 and 97) and 8 x 64^3, K15/bf16 (cg) and
    K16/bf16 against their plain versions at 1 x 100^3 (plain, kernel,
    kernel, plain); the 128^3 bf16 explicit solves on auto (DIA, ELL; legs
    of 17 and 145) with one 50-iteration solve's device busy share, and the
    three bf16 file tiers at 4 x 128^3/4 (legs of 17 and 145)."""
    from hpccg_tpu_torch import ProblemConfig, make_cg
    from hpccg_tpu_torch.ops.cuda import collective as col
    from hpccg_tpu_torch.parallel import generate_problem_sharded, make_distributed_cg
    from hpccg_tpu_torch.parallel.cg import local_operator
    from hpccg_tpu_torch.utils.timing import time_loop_slope

    def slope(run, long=97):
        return time_loop_slope(run, device="cuda", short=17, long=long) * 1e6

    bf = torch.bfloat16
    for ndev, dims in ((1, (100, 100, 100)), (8, (64, 64, 64))):
        for dtype in (torch.float32, bf):
            cfg = ProblemConfig(*dims, dtype=dtype)
            mesh = _one_card(ndev)
            prob = generate_problem_sharded(cfg, mesh)
            n = cfg.local_nrow * ndev
            for method in ("cg", "cg1", "pipecg"):
                t = slope(lambda k: make_distributed_cg(cfg, mesh, max_iter=k + 1, backend="collective",
                                                        method=method)(prob.b, prob.x0))
                say(f"[timing] {ndev} x {dims[0]}^3 {str(dtype)[6:]} collective {method}: {t:.2f} us/iter, "
                    f"{27 * n / t / 1e3:.1f} Gnnz/s ({ndev} ranks on one card) [{card}]")
    cfg = ProblemConfig(100, 100, 100, dtype=bf)
    op, prob = local_operator(cfg), generate_problem_sharded(cfg, _one_card(1))
    for name, method in ((C15, "cg"), (C16, "pipecg")):
        kern = _coll_kernel(method)

        def plain(k):
            col.solve_plain(op, prob.b, prob.x0, method=method, max_iter=k + 1)

        def kernel(k):
            kern(op, prob.b, prob.x0, max_iter=k + 1)

        t_p1, t_k1, t_k2, t_p2 = (slope(f) for f in (plain, kernel, kernel, plain))
        stats[name]["ms"], stats[name]["plain_ms"] = (t_k1 + t_k2) / 2e3, (t_p1 + t_p2) / 2e3
        # one iteration: its state read and written once (cg: x, r, p; pipecg: x, r, w, p, s, z), 2 bytes each
        nvec = 6 if method == "cg" else 12
        _model(stats[name], nvec * op.local_nrow * 2, 2 * op.nnz + 2 * nvec * op.local_nrow, 2)
        say(f"[timing] {name} ({method}) at 1 x 100^3 bf16: {stats[name]['ms'] * 1e3:.2f} us/iter vs plain "
            f"{stats[name]['plain_ms'] * 1e3:.2f}, bound {_bound(stats[name])[0] * 1e3:.2f} [{card}]")
    g = generate_problem_sharded(cfg, _one_card(1))

    def one(k):
        make_distributed_cg(cfg, _one_card(1), max_iter=k + 1, backend="collective", method="cg")(g.b, g.x0)

    _busy_share(one, 100, card, "1 x 100^3 bf16 collective cg one 100-iteration solve", "collective_kernel")
    prob32, dia32 = _explicit_128(torch.float32)
    b, x0 = prob32.b.to(bf), prob32.x0.to(bf)
    for tag, A, kname in (("DIA", _bf16_dia(dia32), "dia_spmv_bf16"), ("ELL", _cast(prob32.A, bf),
                                                                        "ell_spmv_kernel")):
        last = []

        def run(k, A=A):
            last.append(make_cg(A, max_iter=k + 1, tolerance=0.0)(b, x0))

        t = slope(run, long=145)
        say(f"[timing] 128^3 bf16 {tag} auto: {t:.2f} us/iter, {27 * prob32.total_nrow / t / 1e3:.1f} Gnnz/s "
            f"(long-leg niters {int(last[-1].niters)}) [{card}]")
        _busy_share(run, BF16_FILE_ITERS, card, f"128^3 bf16 {tag} auto one {BF16_FILE_ITERS}-iteration solve", kname)
    # the bf16 file tiers at 4 x 128^3/4: the CLI runs a non-DIA bf16 file on ell-allgather (the JAX package's
    # tier there), the API also on ell-halo
    mesh = _one_card(FILE_NDEV)
    shards = {"dia": _sharded_file_problem(_bf16_dia(dia32), mesh, b), "ell": _sharded_file_problem(
        _cast(prob32.A, bf), mesh, b)}
    for tier in ("dia-halo", "ell-halo", "ell-allgather"):
        sp = shards["dia" if tier.startswith("dia") else "ell"]
        t = slope(lambda k, tier=tier, sp=sp: _file_tier(tier)(mesh, max_iter=k + 1)(sp.A, sp.b, sp.x0), long=145)
        say(f"[timing] 4 x 128^3/4 bf16 {tier}: {t:.2f} us/iter, {27 * prob32.total_nrow / t / 1e3:.1f} Gnnz/s "
            f"(4 ranks on one card) [{card}]")


# ------------------------------------------------------------ slice 8: K3 and K4 redesigned

# the grids at the edges of the stencil kernels' tile (V points a thread, a
# tile TX = 32 V wide and TY high, at most ZC planes a block)
EDGES = ["nx<V", "nx=100", "nx=TX-1", "nx=TX+1", "ny%TY", "nz<ZC", "nz=ZC+1"]
BIG_SHAPE = (256, 256, 256)  # K3/K4 f32's second timing shape: 268 / 403 MB, past the 50 MB L2


def _edge_shape(edge, dtype):
    """(nx, ny, nz) at ``edge`` of the stencil kernels' geometry for dtype;
    the z edges on grids with enough xy tiles that the kernel keeps ZC
    (checked)."""
    from hpccg_tpu_torch.ops.cuda import stencil as st

    geo = st.tile_geometry(64, 64, 64, dtype)
    tx, ty = geo.tile_x, geo.tile_y
    shapes = {"nx<V": (max(tx // 32 - 1, 1), ty + 3, 5), "nx=100": (100, ty + 3, 7), "nx=TX-1": (tx - 1, ty + 1, 6),
              "nx=TX+1": (tx + 1, 2 * ty + 1, 5), "ny%TY": (33, 3 * ty + 5, 9)}
    if edge in shapes:
        return shapes[edge]
    zmax = st.tile_geometry(tx * 8, ty * 128, 4096, dtype).z_chunk
    nz = zmax - 1 if edge == "nz<ZC" else zmax + 1
    for k in (16, 32, 64, 128, 256, 512, 1024):
        if st.tile_geometry(tx + 1, ty * k + 1, nz, dtype).z_chunk == zmax:
            return tx + 1, ty * k + 1, nz
    raise AssertionError(f"no grid keeps the z chunk at {zmax}")


def _edge_vec(got, want, dtype, what) -> float:
    return _bf16_vec(got, want, what) if dtype == torch.bfloat16 else _vec_err(got, want, dtype, what)


def _edge_dot(a, b, dtype, what) -> None:
    return _bf16_dot(a, b, what) if dtype == torch.bfloat16 else _dot_err(a, b, dtype, what)


def _k3_k4_case(op, r, p, ap, halo4, beta, tag, out=None):
    """K3 (with and without halo planes) and K4 against their plain versions:
    p', x', r' bit for bit, Ap' within VEC_RTOL (bf16: 4 ulps of max|Ap'|),
    partials within DOT_RTOL (bf16 BF16_DOT_RTOL); a second launch of each
    bit-identical, partials included. ``out`` (p', Ap' and K4's x, r): the
    buffers to write into (views, for unaligned cases). Returns
    max|kernel - plain| of K3 (over Ap') and of K4 (over x', r')."""
    from hpccg_tpu_torch.ops.cuda import fused_cg as fc
    from hpccg_tpu_torch.ops.cuda import stencil as st

    dtype, err = r.dtype, 0.0
    bufs = out or (torch.empty_like(r), torch.empty_like(r), p.clone(), r.clone())
    for halo in (None, halo4):
        what = f"K3 {tag} halo={halo is not None}"
        pp, app, parts = st.update_p_apply(op, r, p, beta, halo, out_p=bufs[0], out_ap=bufs[1])
        pp0, app0, parts0 = st.update_p_apply_plain(op, r, p, beta, halo)
        _same(pp, pp0, f"{what} p' against plain")
        err = max(err, _edge_vec(app, app0, dtype, f"{what} Ap'"))
        _edge_dot(parts.sum(), parts0.sum(), dtype, f"{what} p'.Ap'")
        first = [t.clone() for t in (pp, app, parts)]
        again = st.update_p_apply(op, r, p, beta, halo, out_p=bufs[0], out_ap=bufs[1])
        for a, b in zip(first, again):
            _same(a, b, f"{what} repeat")
    x1, r1 = bufs[2], bufs[3]
    x1.copy_(p)
    r1.copy_(r)
    x2, r2 = p.clone(), r.clone()
    _, _, parts = fc.update_x_r(x1, r1, ap, r, beta)
    _, _, parts0 = fc.update_x_r_plain(x2, r2, ap, r, beta)
    _same(x1, x2, f"K4 x' {tag}")
    _same(r1, r2, f"K4 r' {tag}")
    _edge_dot(parts.sum(), parts0.sum(), dtype, f"K4 r'.r' {tag}")
    x1.copy_(p)
    r1.copy_(r)
    _same(parts, fc.update_x_r(x1, r1, ap, r, beta)[2], f"K4 {tag} repeat partials")
    return err, max(float((x1.double() - x2.double()).abs().max()), float((r1.double() - r2.double()).abs().max()))


def phase_tile_edges(card: str) -> dict:
    """K3 and K4 (and K1/K2, K7 on the same grids) against their plain
    versions on grids at the edges of the stencil kernels' tile, in float32,
    float64 and bfloat16, 27- and 7-point, with and without halo planes, and
    on views at odd element offsets (narrower accesses; K4 also with its
    four arrays at different offsets); then K3 and K4 float32 at 256^3:
    checked, timed (plain, kernel, kernel, plain) and modelled, the kernels
    line's 256^3 rows."""
    from hpccg_tpu_torch.config import Stencil
    from hpccg_tpu_torch.operators import StencilOperator
    from hpccg_tpu_torch.ops.cuda import fused_cg as fc
    from hpccg_tpu_torch.ops.cuda import stencil as st

    gen = torch.Generator(device="cuda").manual_seed(808)

    def rnd(shape, dtype, offset=0):
        n = math.prod(shape)
        t = torch.randn((n + offset,), generator=gen, device="cuda", dtype=torch.float64).to(dtype)
        return t[offset:].view(shape)

    for dtype in (torch.float32, torch.float64, torch.bfloat16):
        sdt = torch.float64 if dtype == torch.float64 else torch.float32
        beta = torch.tensor([0.37], device="cuda", dtype=sdt)
        for edge in EDGES:
            nx, ny, nz = _edge_shape(edge, dtype)
            for stencil in (Stencil.S27, Stencil.S7):
                op = StencilOperator(nx, ny, nz, stencil, dtype)
                grid, tag = (nz, ny, nx), f"{edge} {nx}x{ny}x{nz} {stencil.value}pt {str(dtype)[6:]}"
                r, p, ap = rnd(grid, dtype), rnd(grid, dtype), rnd(grid, dtype)
                h2, h4 = rnd((2, ny, nx), dtype), rnd((4, ny, nx), dtype)
                err3, err4 = _k3_k4_case(op, r, p, ap, h4, beta, tag)
                for halo in (None, h2):  # K1 and K2 on the same grid
                    _edge_vec(st.spmv_stencil(op, r, halo), st.spmv_stencil_plain(op, r, halo), dtype, f"K1 {tag}")
                    y, parts = st.spmv_stencil_pap(op, r, halo)
                    y0, parts0 = st.spmv_stencil_pap_plain(op, r, halo)
                    _edge_vec(y, y0, dtype, f"K2 {tag}")
                    _edge_dot(parts.sum(), parts0.sum(), dtype, f"K2 {tag}")
                    if dtype == torch.float64:
                        y, parts = st.spmv_stencil_pap_dd(op, r, halo)
                        _vec_err(y, y0, dtype, f"K7 {tag}")
                        _dot_err(parts.sum(), parts0.sum(), dtype, f"K7 {tag}")
                say(f"[edges] {tag}: ok, p' x' r' bit for bit, repeats bit-identical, max err K3 {err3:.2e} "
                    f"K4 {err4:.2e}")
        # views at odd element offsets: inputs, outputs and halo planes
        nx, ny, nz = 100, 9, 7
        op, grid = StencilOperator(nx, ny, nz, Stencil.S27, dtype), (nz, ny, nx)
        r, p, ap = rnd(grid, dtype, 1), rnd(grid, dtype, 3), rnd(grid, dtype, 1)
        h2, h4 = rnd((2, ny, nx), dtype, 1), rnd((4, ny, nx), dtype, 3)
        tag = f"views at odd offsets {nx}x{ny}x{nz} {str(dtype)[6:]}"
        # K4's four arrays at one odd offset (a scalar head, then 16-byte vectors), then at 5/7/1/1 (all scalar)
        _k3_k4_case(op, r, p, ap, h4, beta, tag, out=(rnd(grid, dtype, 3), rnd(grid, dtype, 1),
                                                     rnd(grid, dtype, 1), rnd(grid, dtype, 1)))
        _k3_k4_case(op, r, p, ap, h4, beta, f"{tag}, K4 arrays at offsets 5/7/1/1",
                    out=(rnd(grid, dtype, 3), rnd(grid, dtype, 1), rnd(grid, dtype, 5), rnd(grid, dtype, 7)))
        for halo in (None, h2):
            out = rnd(grid, dtype, 1)
            _edge_vec(st.spmv_stencil(op, r, halo, out=out), st.spmv_stencil_plain(op, r, halo), dtype, f"K1 {tag}")
            y, parts = st.spmv_stencil_pap(op, r, halo, out=out)
            y0, parts0 = st.spmv_stencil_pap_plain(op, r, halo)
            _edge_vec(y, y0, dtype, f"K2 {tag}")
            _edge_dot(parts.sum(), parts0.sum(), dtype, f"K2 {tag}")
        say(f"[edges] {tag}: ok")
    # K3 and K4 float32 at 256^3, the kernels line's second rows
    op = StencilOperator(*BIG_SHAPE, Stencil.S27, torch.float32)
    grid = BIG_SHAPE[::-1]
    r, p, ap = rnd(grid, torch.float32), rnd(grid, torch.float32), rnd(grid, torch.float32)
    beta = torch.tensor([0.37], device="cuda")
    stats = {BIG3: {}, BIG4: {}}
    errs = _k3_k4_case(op, r, p, ap, rnd((4, 256, 256), torch.float32), beta, "256^3 27pt float32")
    stats[BIG3]["max_abs_err"], stats[BIG4]["max_abs_err"] = errs
    out, out2, x, rr = (torch.empty_like(r) for _ in range(4))
    x.copy_(p)
    rr.copy_(r)
    parts3 = torch.empty((st.num_partials(op, "cuda"),), device="cuda")
    parts4 = torch.empty((fc.num_update_partials(r.numel(), "cuda"),), device="cuda")
    zero = torch.zeros((1,), device="cuda")  # keeps x and r as they are
    _time_pair(stats[BIG3], lambda: st.update_p_apply(op, r, p, beta, out_p=out, out_ap=out2, partials=parts3),
               lambda: st.update_p_apply_plain(op, r, p, beta, out_p=out, out_ap=out2))
    _time_pair(stats[BIG4], lambda: fc.update_x_r(x, rr, p, ap, zero, partials=parts4),
               lambda: fc.update_x_r_plain(x, rr, p, ap, zero))
    n = op.local_nrow
    _model(stats[BIG3], 4 * n * 4, 2 * op.nnz + 4 * n, 4)
    _model(stats[BIG4], 6 * n * 4, 6 * n, 4)
    for name in SLICE8:
        stat = stats[name]
        say(f"[edges] {name}: {stat['ms'] * 1e3:.2f} us vs plain {stat['plain_ms'] * 1e3:.2f}, bound "
            f"{_bound(stat)[0] * 1e3:.2f} ({_gbs(stat['bytes'], stat['ms']):.0f} GB/s) [{card}]")
    return stats


def _main_path_slice8() -> None:
    """make_cg at 256^3 float32 on auto (= pallas_fused: one K3, without
    its Ap' store, and one K4s launch an iteration), max_iter 50, against
    the stencil backend's trace; two runs bit-identical."""
    big = _solve_all(BIG_SHAPE, 50, ["auto", "stencil"])
    delta = big["auto"][1]
    if delta[BIG3] != 49 or delta[K3N] != 49 or delta[K4S] != 49 or delta[BIG4]:
        raise AssertionError(f"256^3 pallas_fused: expected 49 K3 (without Ap') and 49 K4s launches and no K4, "
                             f"got {delta}")
    worst, tail = _trace_check(big["auto"][0], big["stencil"][0], "slice 8: 256^3 auto")
    again = _solve_all(BIG_SHAPE, 50, ["pallas_fused"])["pallas_fused"][0]
    if not torch.equal(again, big["auto"][0]):
        raise AssertionError("two 256^3 pallas_fused solves gave different traces")
    say(f"[main] slice 8, 256^3 auto (pallas_fused): trace within {worst:.2e} of stencil's above 1e-7 of "
        f"trace[0], {tail:.2e} below; a second solve bit-identical")


def _main_path_slice8_fused() -> None:
    """K3 with its Ap' store and K4 at 256^3 float32 on their main path:
    make_distributed_cg on pallas_fused over 2 ranks of 256x256x128 on the
    card (K3 with Ap' and K4 on each rank, no K4s), max_iter 50, against
    the single-device stencil trace of the 256^3 grid (which launches
    nothing)."""
    from hpccg_tpu_torch import ProblemConfig
    from hpccg_tpu_torch.parallel import generate_problem_sharded, make_distributed_cg

    ref = _solve_all(BIG_SHAPE, 50, ["stencil"])["stencil"][0]
    cfg = ProblemConfig(256, 256, 128, dtype=torch.float32)
    mesh = _one_card(2)
    prob = generate_problem_sharded(cfg, mesh)
    before = _counts()
    res = make_distributed_cg(cfg, mesh, max_iter=50, tolerance=0.0, backend="pallas_fused")(prob.b, prob.x0)
    torch.cuda.synchronize()
    delta = {n: c - before[n] for n, c in _counts().items()}
    if int(res.niters) != 49 or delta[BIG3] != 2 * 49 or delta[BIG4] != 2 * 49 or delta[K3N] or delta[K4S]:
        raise AssertionError(f"2 x 256x256x128 pallas_fused: niters {int(res.niters)}, launches {delta}")
    worst, tail = _trace_check(res.trace.double().cpu(), ref, "slice 8: 2 x 256x256x128 pallas_fused")
    say(f"[main] slice 8, 2 x 256x256x128 distributed pallas_fused (K3 with Ap', K4): trace within {worst:.2e} "
        f"of the single-device stencil trace above 1e-7 of trace[0], {tail:.2e} below")


UPDATE_SHAPE = (300, 300, 300)  # the benchmark's stencil27_f64.ref300 grid: K3 without Ap' and K4s rows


def _k3n_k4s_case(op, x, r, p, beta, alpha, tag) -> tuple:
    """K3 without its Ap' store and K4s on (x, r, p) against K3 with Ap' and
    K4 on the card (p', x', r' and K3's partials bit for bit: K4s forms A p'
    as K3 forms Ap'; the new r.r's sums within the dot tolerance, the two
    group their partials differently) and against their plain versions (p'
    and x' bit for bit, r' and the partials' sums within the tolerances);
    a repeat gives the same bits. Returns the largest |kernel - plain| of
    K3's p' . Ap' sum and of K4s's r'."""
    from hpccg_tpu_torch.ops.cuda import fused_cg as fc
    from hpccg_tpu_torch.ops.cuda import stencil as st

    dtype = x.dtype

    def run():
        pp, ap, part3 = st.update_p_apply(op, r, p, beta, store_ap=False)
        xs, rs = x.clone(), r.clone()
        _, _, part4 = st.update_x_r_stencil(op, xs, rs, pp, alpha)
        return ap, (pp, xs, rs, part3, part4)

    ap, got = run()
    if ap is not None or not all(torch.equal(a, b) for a, b in zip(got, run()[1])):
        raise AssertionError(f"K3 without Ap' / K4s {tag}: a repeat differs (or Ap' was returned)")
    pp, xs, rs, part3, part4 = got
    pk, apk, part3k = st.update_p_apply(op, r, p, beta)
    xk, rk = x.clone(), r.clone()
    _, _, part4k = fc.update_x_r(xk, rk, pk, apk, alpha)
    if not all(torch.equal(a, b) for a, b in zip((pp, xs, rs, part3), (pk, xk, rk, part3k))):
        raise AssertionError(f"K3 without Ap' / K4s {tag}: p', x', r' or K3's partials differ from K3 + K4's")
    _edge_dot(part4.sum(), part4k.sum(), dtype, f"K4s r.r vs K4's {tag}")
    xp, rp = x.clone(), r.clone()
    _, _, part_p = st.update_x_r_stencil_plain(op, xp, rp, pp, alpha)
    if not torch.equal(xs, xp):
        raise AssertionError(f"K4s {tag}: x' differs from its plain version's")
    err4 = _edge_vec(rs, rp, dtype, f"K4s r' {tag}")
    _edge_dot(part4.sum(), part_p.sum(), dtype, f"K4s r.r {tag}")
    part3p = st.update_p_apply_plain(op, r, p, beta, store_ap=False)[2]
    _edge_dot(part3.sum(), part3p.sum(), dtype, f"K3 without Ap' p'.Ap' {tag}")
    return float((part3.sum() - part3p.sum()).abs()), err4


def phase_stencil_update(card) -> dict:
    """K3 without its Ap' store and K4s (_k3n_k4s_case) at 33x17x9, 100^3
    and 64x48x130, 27- and 7-point, in float32, float64 and bfloat16, and
    on views at odd element offsets; then both timed against their plain
    versions at UPDATE_SHAPE float64 (the kernels line's rows), with K3
    (Ap' stored) and K4 on the same inputs beside them."""
    from hpccg_tpu_torch.config import Stencil
    from hpccg_tpu_torch.operators import StencilOperator
    from hpccg_tpu_torch.ops.cuda import fused_cg as fc
    from hpccg_tpu_torch.ops.cuda import stencil as st

    gen = torch.Generator(device="cuda").manual_seed(16)

    def rnd(shape, dtype, offset=0):
        n = math.prod(shape)
        v = torch.randn((n + offset,), generator=gen, device="cuda", dtype=torch.float64).to(dtype)
        return v[offset:].view(shape)

    def scalars(dtype):
        sdt = torch.float64 if dtype == torch.float64 else torch.float32
        return (torch.tensor([0.37], device="cuda", dtype=sdt), torch.tensor([0.29], device="cuda", dtype=sdt))

    for dtype in (torch.float32, torch.float64, torch.bfloat16):
        for dims in SHAPES:
            for stencil in (Stencil.S27, Stencil.S7):
                op = StencilOperator(*dims, stencil, dtype)
                grid = dims[::-1]
                tag = f"{dims[0]}x{dims[1]}x{dims[2]} {stencil.value}pt {str(dtype)[6:]}"
                e3, e4 = _k3n_k4s_case(op, rnd(grid, dtype), rnd(grid, dtype), rnd(grid, dtype), *scalars(dtype),
                                       tag)
                say(f"[update] {tag}: ok, K3 without Ap' and K4s bit for bit against K3 + K4; against plain: "
                    f"p'.Ap' {e3:.2e}, r' {e4:.2e}")
        nx, ny, nz = 100, 9, 7
        op = StencilOperator(nx, ny, nz, Stencil.S27, dtype)
        tag = f"views at odd offsets {nx}x{ny}x{nz} {str(dtype)[6:]}"
        _k3n_k4s_case(op, *(rnd((nz, ny, nx), dtype, off) for off in (1, 3, 5)), *scalars(dtype), tag)
        say(f"[update] {tag}: ok")
    op = StencilOperator(*UPDATE_SHAPE, Stencil.S27, torch.float64)
    grid = UPDATE_SHAPE[::-1]
    r, p, x = (rnd(grid, torch.float64) for _ in range(3))
    beta = torch.tensor([0.37], device="cuda", dtype=torch.float64)
    zero = torch.zeros((1,), device="cuda", dtype=torch.float64)  # the timed K4s keeps x and r as they are
    stats = {K3N: {}, K4S: {}}
    stats[K3N]["max_abs_err"], stats[K4S]["max_abs_err"] = _k3n_k4s_case(op, x, r, p, *scalars(torch.float64),
                                                                         "300^3 27pt float64")
    out, out2, rr = torch.empty_like(r), torch.empty_like(r), r.clone()
    parts3 = torch.empty((st.num_partials(op, "cuda"),), device="cuda", dtype=torch.float64)
    parts4 = torch.empty((fc.num_update_partials(r.numel(), "cuda"),), device="cuda", dtype=torch.float64)
    _time_pair(stats[K3N], lambda: st.update_p_apply(op, r, p, beta, out_p=out, partials=parts3, store_ap=False),
               lambda: st.update_p_apply_plain(op, r, p, beta, out_p=out, store_ap=False))
    _time_pair(stats[K4S], lambda: st.update_x_r_stencil(op, x, rr, p, zero, partials=parts3),
               lambda: st.update_x_r_stencil_plain(op, x, rr, p, zero))
    n, nnz = op.local_nrow, op.nnz
    _model(stats[K3N], 3 * n * 8, 2 * nnz + 4 * n, 8)
    _model(stats[K4S], 5 * n * 8, 2 * nnz + 6 * n, 8)
    k3 = _graph_ms(lambda: st.update_p_apply(op, r, p, beta, out_p=out, out_ap=out2, partials=parts3))
    k4 = _graph_ms(lambda: fc.update_x_r(x, rr, p, out2, zero, partials=parts4))
    for name in SLICE16:
        stat = stats[name]
        say(f"[update] {name}: {stat['ms'] * 1e3:.2f} us vs plain {stat['plain_ms'] * 1e3:.2f}, bound "
            f"{_bound(stat)[0] * 1e3:.2f} ({_gbs(stat['bytes'], stat['ms']):.0f} GB/s) [{card}]")
    say(f"[update] beside them on the same inputs: K3 with Ap' {k3 * 1e3:.2f} us ({_gbs(4 * n * 8, k3):.0f} GB/s), "
        f"K4 {k4 * 1e3:.2f} us ({_gbs(6 * n * 8, k4):.0f} GB/s) [{card}]")
    return stats


def _k3_k4_route():
    """The K3 + K4 route (K3 with its Ap' store, K4: the sequence of the
    parent's pallas_fused) of _main_path_slice16's solve: ``cg_solve_fused``
    given ``halo4``, at UPDATE_SHAPE float64, max_iter 50; solved outside
    that path's drive, so that its launches are not counted as the path's."""
    from hpccg_tpu_torch import ProblemConfig, generate_problem
    from hpccg_tpu_torch.solver import cg_solve_fused

    prob = generate_problem(ProblemConfig(*UPDATE_SHAPE, dtype=torch.float64), "cuda")
    return cg_solve_fused(prob.A, prob.b, prob.x0, max_iter=50, halo4=lambda rs, ps: [None])


def _main_path_slice16(want) -> None:
    """make_cg at UPDATE_SHAPE float64 on auto (= pallas_fused: one K3
    without its Ap' store and one K4s launch an iteration, no K4), max_iter
    50, against ``want``, the K3 + K4 route of the same solve
    (_k3_k4_route; niters equal, trace within WS_TRACE float64, x within
    WS_X_RTOL: the two add r.r's partials in other orders) and against the
    stencil backend's trace."""
    runs = _solve_all(UPDATE_SHAPE, 50, ["auto", "stencil"], torch.float64)
    tr, delta, res = runs["auto"]
    if delta[K3N] != 49 or delta[SLICE1[2]] != 49 or delta[K4S] != 49 or delta[K4]:
        raise AssertionError(f"300^3 f64 pallas_fused: expected 49 K3 (without Ap') and 49 K4s launches and no K4, "
                             f"got {delta}")
    rtol, floor = WS_TRACE[torch.float64]
    worst, tail = _trace_check(tr, want.trace.double().cpu(), "300^3 f64 pallas_fused vs the K3 + K4 route",
                               rtol, floor)
    xerr = float((res.x - want.x).abs().max())
    if int(want.niters) != int(res.niters) or not xerr <= WS_X_RTOL[torch.float64] * float(want.x.abs().max()):
        raise AssertionError(f"300^3 f64 pallas_fused vs the K3 + K4 route: niters {int(res.niters)} vs "
                             f"{int(want.niters)}, max|x - x'| {xerr:.3e}")
    worst_s, _ = _trace_check(tr, runs["stencil"][0], "300^3 f64 pallas_fused vs stencil", rtol, floor)
    say(f"[main] slice 16, 300^3 f64 auto (pallas_fused: K3 without Ap', K4s): trace within {worst:.2e} of the "
        f"K3 + K4 route's above {floor} of trace[0] ({tail:.2e} below), x within {xerr:.2e}; within "
        f"{worst_s:.2e} of stencil's")


def _phase(name, fn, *args):
    """fn(*args), with its seconds printed."""
    t0 = time.perf_counter()
    out = fn(*args)
    say(f"[phase] {name}: {time.perf_counter() - t0:.1f} s")
    return out


def main() -> int:
    card = _phase("device", phase_device)
    _phase("build", phase_build)
    stats = _phase("kernels vs plain (stencil)", phase_kernels)
    stats.update(_phase("whole-solve kernels vs plain", phase_whole_solve_kernels))
    _phase("large offsets", phase_large_offsets)
    stats.update(_phase("sparse kernels vs plain", phase_sparse_kernels, card))
    stats.update(_phase("collective kernels vs plain", phase_collective_kernels))
    _phase("collective kernels across cards", phase_collective_across_cards)
    stats.update(_phase("collective DIA kernel vs plain", phase_collective_dia_kernels))
    stats.update(_phase("bf16 K1-K4 vs plain", phase_bf16_kernels))
    stats.update(_phase("bandwidth probes vs plain", phase_probes, card))
    stats.update(_phase("bf16 K9/K11 vs plain", phase_bf16_sparse_kernels, card))
    stats.update(_phase("bf16 K15/K16 vs plain", phase_collective_bf16_kernels))
    stats.update(_phase("K1-K4 at the tile edges, K3/K4 at 256^3", phase_tile_edges, card))
    stats.update(_phase("K5/K6 at 256^3", phase_whole_solve_256, card))
    stats.update(_phase("K3 without Ap', K4s", phase_stencil_update, card))
    launches = _phase("main paths", phase_main_path)
    for name, key in ((BIG5, (torch.float32, "megakernel")), (BIG6, (torch.float32, "streamkernel")),
                      (BIG5B, (torch.bfloat16, "megakernel")), (BIG6B, (torch.bfloat16, "streamkernel"))):
        stats[name]["max_abs_err"] = MAIN_X_ERR[key]
    _phase("golden", phase_golden)
    _phase("golden, collective", phase_golden_collective)
    _phase("golden, distributed file mode", phase_golden_file_mesh)
    _phase("cli", phase_cli)
    _phase("cli, methods", phase_cli_methods)
    _phase("cli, file mode", phase_cli_files)
    _phase("cli, distributed file mode", phase_cli_file_mesh)
    _phase("cli, bf16 file mode", phase_cli_bf16_files)
    _phase("bench", phase_bench)
    _phase("timing", phase_timing, card)
    _phase("timing, explicit matrices", phase_timing_explicit, card, stats)
    _phase("timing, collective", phase_timing_collective, card, stats)
    _phase("timing, distributed file mode", phase_timing_file_mesh, card, stats)
    _phase("timing, bf16 collective and file mode", phase_timing_bf16, card, stats)
    kernels = []
    for name, (src, rep) in KERNELS.items():
        st = stats[name]
        bound_ms, bound_by = _bound(st)
        kernels.append({"name": name, "route": "cuda", "source": src, "replaces": rep, "launches": launches[name],
                        "max_abs_err": st["max_abs_err"], "ms": st["ms"], "plain_ms": st["plain_ms"],
                        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": st.get("library_ms")})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
