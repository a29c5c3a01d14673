"""The collective whole-solve kernels K15 and K16 (``csrc/collective.cu``)
and K17 (``csrc/collective_dia.cu``): wrappers, plain versions and launch
counters.

- K15 ``cg_collective``: methods ``cg`` (the reference recurrence, two
  allreduces per iteration) and ``cg1`` (Chronopoulos-Gear, one)
  (``collective_kernel.py:_kernel``);
- K16 ``cg_collective_pipelined``: pipelined CG (Ghysels-Vanroose), the
  allreduce in flight while the stencil applies
  (``collective_kernel.py:_kernel_pipelined``);
- K17 ``cg_collective_dia``: K15's cg and cg1 on a banded explicit matrix
  whose rows are block-sharded (``collective_kernel.py:_kernel_dia``), the
  halo being band strips of rows.

K15/K16 solve the z-stacked stencil problem of every rank of a mesh in one
launch. ``b`` and ``x0`` are sharded vectors: tuples of flat per-rank
tensors (rank r's block of ``op``'s local dims), as
``parallel.cg.generate_problem_sharded`` gives them. K17 takes the
matrix's per-rank :class:`DiaRows` and sharded b and x0 as
``parallel.cg.shard_problem`` gives them. The result is a CGResult whose x
is sharded the same way.

The plain version is the sharded recurrence of ``parallel.cg`` with
backend ``stencil``: the halo'd plain matvec, the ranks' partials summed in
rank order; K17's runs it on the plain dia-halo matvec (``DiaRows.matvec``
over ``parallel.halo.BandStrips``). A wrapper runs it only when the shards
lie on the CPU; for CUDA shards it launches the kernel or raises, and
counts its launches in ``<wrapper>.launches`` (and those of K15/K16's
bfloat16 instance in ``<wrapper>.launches_bf16`` too). Every rank of a
launch must share one card: a mesh across cards raises NotImplementedError
(the multi-card launch, with peer pointer tables, is queued in ROADMAP).

dtypes: K15/K16 take float32, float64 and bfloat16 (the JAX kernels run
bf16 too: ``make_distributed_cg(backend="collective")`` has no dtype gate,
and their vectors, alpha/beta and allreduce rows stay in bf16,
``collective_kernel.py:562``, ``:842``). The port's bf16 instance stores the
vectors and the landing planes in bf16 and keeps the partials, the allreduce
table, the scalars, the trace and the stats in float32
(``config.scalar_dtype``), as K1-K6 do; its plain version
(``_solve_plain_bf16``) rounds at the kernel's places and sums the dots as
the kernel does (``rank_dot``: each rank's ``wholesolve.plane_dot``, the
ranks in rank order). K17 takes float32 and
float64 only, as the JAX package's K17 is float32 only
(``hpccg_tpu/parallel/cg.py:1381-1385``): bfloat16 raises ValueError.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from hpccg_tpu_torch.config import scalar_dtype
from hpccg_tpu_torch.operators import DiaRows, StencilOperator, band
from hpccg_tpu_torch.ops.cuda.build import check_launch, load_library
from hpccg_tpu_torch.ops.cuda.dia import MAX_DIAGS
from hpccg_tpu_torch.ops.cuda.wholesolve import plane_dot

METHODS = {"cg": 0, "cg1": 1, "pipecg": 2}
DTYPE_CODES = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2}  # the C entry points' dtype argument
# rows of the kernels' pointer table; the same order as csrc/collective.cuh
(P_B, P_X0, P_X, P_R, P_P, P_S, P_U, P_Z, P_Q, P_H, P_PARTS, P_TABLE, P_CTR, P_DATA, P_V) = range(15)
NKIND, NCTR = 15, 16
# the state vectors of each method (K16 keeps w in P_U and P_V by iteration
# parity)
VECTORS = {"cg": (P_X, P_R, P_P, P_S), "cg1": (P_X, P_R, P_P, P_S, P_U),
           "pipecg": (P_X, P_R, P_P, P_S, P_U, P_Z, P_Q, P_V)}
# the landing buffers of a K15/K16 rank: (phase, from below / from above) planes
PHASES = 5
# how long a spin-wait in the kernel may last before it gives up: far above
# any wait of a healthy solve, far below a hung chip_smoke
WAIT_NS = 5_000_000_000
# error-word sites (csrc/collective.cuh)
SITES = {1: "rank barrier", 2: "rank partials", 3: "allreduce table"}


def _check(nrow: int, bs, x0s) -> torch.device:
    """Raise unless (bs, x0s), shards of ``nrow`` rows, are what the kernels
    take; returns their one device."""
    bs, x0s = tuple(bs), tuple(x0s)
    if not bs or len(bs) != len(x0s):
        raise ValueError(f"b has {len(bs)} shards and x0 {len(x0s)}")
    dtype = bs[0].dtype
    if dtype not in DTYPE_CODES:
        raise TypeError(f"the collective kernels take float32, float64 or bfloat16, got {dtype}")
    for v in bs + x0s:
        if v.dtype != dtype or tuple(v.shape) != (nrow,) or not v.is_contiguous():
            raise ValueError(f"every shard must be a contiguous ({nrow},) {dtype} tensor, got "
                             f"{tuple(v.shape)} {v.dtype}")
    devices = {v.device for v in bs + x0s}
    if len(devices) > 1:
        if all(d.type == "cuda" for d in devices):
            raise NotImplementedError("the collective kernels run every rank of a launch on one card; the "
                                      "multi-card launch (peer pointer tables) is queued in ROADMAP")
        raise ValueError(f"the shards lie on several devices: {sorted(map(str, devices))}")
    if any(b.data_ptr() == x.data_ptr() for b in bs for x in x0s):
        raise ValueError("b and x0 must not alias")
    return devices.pop()


def solve_plain(op: StencilOperator, bs, x0s, *, method: str, max_iter: int, tolerance: float = 0.0):
    """Plain torch K15/K16: the sharded recurrence of ``method`` with the
    plain halo'd matvec (``make_distributed_cg(backend="stencil")``); for
    bfloat16 shards the kernels' storage/compute split
    (``_solve_plain_bf16``)."""
    from hpccg_tpu_torch.ops.cuda.fused_cg import cg_finalize_plain
    from hpccg_tpu_torch.parallel.halo import stencil_matvec_halo
    from hpccg_tpu_torch.solver import ONE_REDUCTION, cg_solve

    def matvec(vs):
        return stencil_matvec_halo(op, vs)

    bs, x0s = tuple(bs), tuple(x0s)
    if bs[0].dtype == torch.bfloat16:
        return _solve_plain_bf16(op, bs, x0s, method=method, max_iter=max_iter, tolerance=tolerance)
    if method == "cg":
        return cg_solve(matvec, bs, x0s, max_iter=max_iter, tolerance=tolerance, finalize=cg_finalize_plain)
    return ONE_REDUCTION[method](matvec, bs, x0s, max_iter=max_iter, tolerance=tolerance)


def _solve_plain_bf16(op: StencilOperator, bs, x0s, *, method: str, max_iter: int, tolerance: float):
    """Plain torch K15/K16 for bfloat16 shards, with the kernels' split
    (``csrc/collective.cuh``): vectors stored in bf16; A v, the dots, the
    scalars and the trace in float32. A value is rounded to bf16 where the
    kernel stores it and used as stored from then on; the dots of an apply
    (p.Ap, r.u, and w.r at pipecg's init) take its unrounded f32 result.
    The dots are the kernel's (``rank_dot``); the loop test is read back
    every iteration. Returns a CGResult with sharded bf16 x."""
    from hpccg_tpu_torch.parallel.halo import stencil_matvec_halo
    from hpccg_tpu_torch.solver import CGResult

    f32, bf16, dev = torch.float32, torch.bfloat16, bs[0].device
    op32 = dataclasses.replace(op, dtype=f32)
    tol = float(torch.tensor(tolerance, dtype=f32))  # the kernel compares in float32
    trace = torch.full((max(max_iter, 1),), float("nan"), dtype=f32, device=dev)

    def A(vs):  # A v in float32 from the stored shards, halo planes included
        return stencil_matvec_halo(op32, tuple(v.float() for v in vs))

    def dot(us, vs):
        return rank_dot(us, vs, op.nz, f32)[0]

    def store(vs):
        return tuple(v.to(bf16) for v in vs)

    def lin(xs, a, ys):  # x + a y in float32, stored in bf16
        return tuple((x.float() + a * y.float()).to(bf16) for x, y in zip(xs, ys))

    def clone(vs):
        return tuple(v.clone() for v in vs)

    x = clone(x0s)
    r = tuple((b.float() - y).to(bf16) for b, y in zip(bs, A(x)))
    k = 1
    if method == "cg":
        p, rr = clone(x0s), dot(r, r)
        rtrans = rtrans_old = rr
        normr = torch.sqrt(rtrans)
        trace[0] = normr
        while k < max_iter and float(normr) > tol:
            rtrans = rr
            beta = torch.zeros((), dtype=f32, device=dev) if k == 1 else rtrans / rtrans_old
            normr = torch.sqrt(rtrans)
            trace[k] = normr
            p = lin(r, beta, p)
            ap = A(p)
            alpha = rtrans / dot(p, ap)
            x = lin(x, alpha, p)
            r = lin(r, -alpha, store(ap))
            rr = dot(r, r)
            rtrans_old = rtrans
            k += 1
        return CGResult(x=x, niters=torch.tensor(k - 1, dtype=torch.int32, device=dev), normr=normr,
                        rtrans=rtrans, trace=trace)
    # cg1 (u = A r) and pipecg (w = A r, q = A w): the one-reduction bodies
    u = A(r)
    w = store(u)
    gamma, delta = dot(r, r), dot(r, u)
    q = store(A(w)) if method == "pipecg" else None
    trace[0] = torch.sqrt(gamma)
    alpha, gamma_top, beta = gamma / delta, gamma, None
    while k < max_iter and float(torch.sqrt(gamma_top)) > tol:
        trace[k] = torch.sqrt(gamma)
        if beta is None:
            p, s = clone(r), clone(w)
            z = clone(q) if q is not None else None
        else:
            p, s = lin(r, beta, p), lin(w, beta, s)
            z = lin(q, beta, z) if q is not None else None
        x = lin(x, alpha, p)
        r = lin(r, -alpha, s)
        if method == "pipecg":
            w = lin(w, -alpha, z)
            g_new, dl = dot(r, r), dot(w, r)
            q = store(A(w))
        else:
            u = A(r)
            w = store(u)
            g_new, dl = dot(r, r), dot(r, u)
        beta = g_new / gamma
        alpha = g_new / (dl - beta * g_new / alpha)
        gamma_top, gamma = gamma, g_new
        k += 1
    return CGResult(x=x, niters=torch.tensor(k - 1, dtype=torch.int32, device=dev), normr=torch.sqrt(gamma_top),
                    rtrans=gamma_top, trace=trace)


def rank_dot(us, vs, nz: int, sdt):
    """The ranks' dot u . v as K15/K16 sum it, in ``sdt``: each rank's
    ``plane_dot`` (its nz z-planes' products added in float64 and rounded
    once, the plane sums added in sdt in z order), the ranks' values added
    in sdt in rank order. Returns a tensor of shape (1,) on the first
    shard's device."""
    total = None
    for u, v in zip(us, vs):
        part = plane_dot(u, v, nz, sdt).to(us[0].device)
        total = part if total is None else total + part
    return total


@dataclasses.dataclass(frozen=True)
class CollectiveGeometry:
    """K15/K16's cooperative grid for a launch: the tile (x points, y rows),
    the z-planes of a work item, and each rank's work items and blocks."""

    tile_x: int
    tile_y: int
    z_chunk: int
    items: int
    blocks_per_rank: int


def geometry(op: StencilOperator, ndev: int, dtype, method: str) -> CollectiveGeometry:
    """The grid of a launch of ``ndev`` ranks of op's local grid in
    ``dtype`` on the current CUDA device: every block resident at once
    (occupancy x SMs, shared by the ranks), a rank's blocks capped by its
    (x-tile, y-tile, z-chunk) work items, which they take in turns. A mesh
    larger than the resident grid raises (nothing falls back)."""
    lib = _library()
    out = (ctypes.c_int * 5)()
    err = lib.hpccg_collective_geometry(op.nx, op.ny, op.nz, DTYPE_CODES[dtype], op.stencil.value, METHODS[method],
                                        ndev, ctypes.addressof(out))
    if err == 720:  # cudaErrorCooperativeLaunchTooLarge
        raise ValueError(f"a mesh of {ndev} ranks needs at least {ndev} resident blocks of the collective kernel")
    if err != 0:
        raise RuntimeError(f"collective kernel: no cooperative grid (CUDA error {err})")
    return CollectiveGeometry(*out)


def _library():
    """The kernel library, once its counter and pointer layout is checked
    against this module's."""
    lib = load_library()
    if (lib.hpccg_collective_layout(0), lib.hpccg_collective_layout(1)) != (NCTR, NKIND):
        raise RuntimeError("collective kernel: the library's counter / pointer layout differs from this module's")
    return lib


def _resident(resident: int, ndev: int, what: str) -> int:
    """The resident blocks a query returned, or raise: no cooperative grid,
    or fewer blocks than ranks (nothing falls back)."""
    _library()
    if resident <= 0:
        raise RuntimeError(f"{what}: no cooperative grid (CUDA error {-resident})")
    if resident < ndev:
        raise ValueError(f"a mesh of {ndev} ranks needs at least {ndev} resident blocks; this card holds "
                         f"{resident} of the {what}")
    return resident


def _pitch(n: int, dtype) -> int:
    """n elements of ``dtype`` rounded up to a multiple of 16 bytes."""
    per = 16 // torch.empty((), dtype=dtype).element_size()
    return -(-n // per) * per


def access_bytes(nx: int, esize: int, ptrs) -> int:
    """The widest access of 16, 8, 4 or 2 bytes that divides the row pitch
    nx * esize and every pointer (``stencil_stage.cuh:access_bytes``)."""
    m = 16 | nx * esize
    for p in ptrs:
        m |= p
    return m & -m


class _Scratch:
    """The device state of one collective launch: the solve vectors, the
    landing buffers, the partials, the allreduce tables, the counters, the
    trace, the stats and the error word, and the pointer table that names
    them per rank. The vectors and landing buffers are in the shards'
    dtype, each rank's vector 16-byte aligned; the partials ``parts``
    (shape per rank, dtype; default ``2 * bpr`` in the scalar dtype, K17's
    block partials) and the rest in the scalar dtype (float32 for
    bfloat16)."""

    def __init__(self, bs, x0s, kinds, landing_shape, bpr: int, max_iter: int, data=None, parts=None):
        dev, dtype, ndev, n = bs[0].device, bs[0].dtype, len(bs), bs[0].numel()
        sdt = scalar_dtype(dtype)
        self.state = torch.zeros((len(kinds), ndev, _pitch(n, dtype)), dtype=dtype, device=dev)[:, :, :n]
        # the landing buffers a rank's neighbours push into; zero at the global ends
        self.landing = torch.zeros((ndev, *landing_shape), dtype=dtype, device=dev)
        shape, pdt = parts if parts is not None else ((2 * bpr,), sdt)
        self.parts = torch.empty((ndev, *shape), dtype=pdt, device=dev)
        self.table = torch.zeros((ndev, 2, ndev, 2), dtype=sdt, device=dev)
        self.ctr = torch.zeros((ndev, NCTR), dtype=torch.int32, device=dev)
        self.trace = torch.full((max(max_iter, 1),), float("nan"), dtype=sdt, device=dev)
        self.stats = torch.zeros((4,), dtype=sdt, device=dev)
        self.err = torch.zeros((4,), dtype=torch.int32, device=dev)
        rows = [[0] * ndev for _ in range(NKIND)]
        for r in range(ndev):
            rows[P_B][r], rows[P_X0][r] = bs[r].data_ptr(), x0s[r].data_ptr()
            for j, kind in enumerate(kinds):
                rows[kind][r] = self.state[j, r].data_ptr()
            rows[P_H][r] = self.landing[r].data_ptr()
            rows[P_PARTS][r] = self.parts[r].data_ptr()
            rows[P_TABLE][r] = self.table[r].data_ptr()
            rows[P_CTR][r] = self.ctr[r].data_ptr()
            if data is not None:
                rows[P_DATA][r] = data[r].data_ptr()
        self.ptrs = torch.tensor(rows, dtype=torch.int64, device=dev)

    def result(self, wait_ns: int, what: str):
        """Synchronises to read the error word, raises RuntimeError if a wait
        gave up, else returns the CGResult (x sharded, kinds[0] being P_X)."""
        from hpccg_tpu_torch.solver import CGResult

        word = self.err.tolist()
        if word[0]:
            site = word[1]
            where = SITES.get(site) or f"halo of phase {(site - 16) // 2} from {'above' if site % 2 else 'below'}"
            raise RuntimeError(f"collective kernel: a wait gave up after {wait_ns} ns ({where}, rank {word[2]}, "
                               f"expected count {word[3]}); {what}")
        x = tuple(self.state[0, r] for r in range(self.state.shape[1]))
        stats = self.stats
        return CGResult(x=x, niters=stats[2].to(torch.int32), normr=stats[0], rtrans=stats[1], trace=self.trace)


def launch(op: StencilOperator, bs, x0s, *, method: str, max_iter: int, tolerance: float = 0.0,
           wait_ns: int = WAIT_NS):
    """One cooperative launch of the collective kernel for every rank, on
    the shards' card and the current stream; synchronises to read the
    kernel's error word and raises RuntimeError if a wait gave up. Records
    the access widths in bytes of the march (state vectors and landing
    planes; with b and x0 at the init) in ``launch.access``. Returns a
    CGResult."""
    dev = bs[0].device
    dtype = bs[0].dtype
    ndev = len(bs)
    with torch.cuda.device(dev):
        g = geometry(op, ndev, dtype, method)
    tiles = -(-op.nx // g.tile_x) * -(-op.ny // g.tile_y)
    plane = _pitch(op.nx * op.ny, dtype)
    # per rank: two rounds (by parity) of two dots of (tile, plane) partials
    sc = _Scratch(bs, x0s, VECTORS[method], (PHASES * 2 * plane,), g.blocks_per_rank, max_iter,
                  parts=((4 * tiles * op.nz,), torch.float64))
    esize = bs[0].element_size()
    # every state vector and landing plane lies a multiple of 16 bytes from these
    ptrs = [sc.state.data_ptr(), sc.landing.data_ptr()]
    access = access_bytes(op.nx, esize, ptrs)
    init_access = access_bytes(op.nx, esize, ptrs + [v.data_ptr() for v in bs + x0s])
    launch.access = (access, init_access)
    lib = load_library()
    fn = {torch.float32: lib.hpccg_collective_f32, torch.float64: lib.hpccg_collective_f64,
          torch.bfloat16: lib.hpccg_collective_bf16}[dtype]
    # the C entry points launch on the current device, which must be the stream's
    with torch.cuda.device(dev):
        code = fn(sc.ptrs.data_ptr(), sc.trace.data_ptr(), sc.stats.data_ptr(), sc.err.data_ptr(), ndev, op.nx,
                  op.ny, op.nz, plane, access, init_access, sc.parts[0].numel(), op.stencil.value, METHODS[method],
                  max_iter, float(tolerance), int(wait_ns), torch.cuda.current_stream(dev).cuda_stream)
    check_launch(code, "collective kernel (cooperative launch)")
    return sc.result(wait_ns, f"{ndev} ranks x {g.blocks_per_rank} blocks")


launch.access = None


def _solve(wrapper, op, bs, x0s, method, max_iter, tolerance):
    if method not in METHODS:
        raise ValueError(f"unknown CG method {method!r}")
    dev = _check(op.local_nrow, bs, x0s)
    if dev.type == "cpu":
        return solve_plain(op, bs, x0s, method=method, max_iter=max_iter, tolerance=tolerance)
    res = launch(op, tuple(bs), tuple(x0s), method=method, max_iter=max_iter, tolerance=tolerance)
    wrapper.launches += 1
    if bs[0].dtype == torch.bfloat16:
        wrapper.launches_bf16 += 1
    return res


def cg_collective(op: StencilOperator, bs, x0s, *, method: str = "cg1", max_iter: int, tolerance: float = 0.0):
    """K15: the whole multi-rank solve in one launch, method ``cg`` or
    ``cg1`` (plain on the CPU). Returns a CGResult with sharded x."""
    if method not in ("cg", "cg1"):
        raise ValueError(f"K15 runs methods cg and cg1, got {method!r} (pipecg is K16)")
    return _solve(cg_collective, op, bs, x0s, method, max_iter, tolerance)


cg_collective.launches = cg_collective.launches_bf16 = 0


def cg_collective_pipelined(op: StencilOperator, bs, x0s, *, max_iter: int, tolerance: float = 0.0):
    """K16: the whole multi-rank pipelined CG solve in one launch (plain on
    the CPU). Returns a CGResult with sharded x."""
    return _solve(cg_collective_pipelined, op, bs, x0s, "pipecg", max_iter, tolerance)


cg_collective_pipelined.launches = cg_collective_pipelined.launches_bf16 = 0


# ------------------------------------------------ K17: the banded matrix


def _check_dia(blocks, bs, x0s) -> torch.device:
    """Raise unless (blocks, bs, x0s) are what K17 takes; returns their one
    device."""
    blocks = tuple(blocks)
    if not blocks or not all(isinstance(blk, DiaRows) for blk in blocks):
        raise TypeError("K17 takes the DiaRows of each rank (parallel.cg.shard_problem)")
    if len(blocks) != len(tuple(bs)):
        raise ValueError(f"{len(blocks)} row blocks and {len(tuple(bs))} shards of b")
    first = blocks[0]
    L = first.local_nrow
    if any(blk.offsets != first.offsets or blk.local_nrow != L for blk in blocks):
        raise ValueError("every rank's row block must have the same rows and offsets")
    if tuple(bs)[0].dtype == torch.bfloat16:
        raise ValueError("K17 takes float32 or float64; bfloat16 has no instance (the JAX package's collective "
                         "DIA kernel is float32 only, hpccg_tpu/parallel/cg.py:1381-1385)")
    dev = _check(L, bs, x0s)
    for blk in blocks:
        if blk.dtype != bs[0].dtype or blk.device != dev or not blk.data.is_contiguous():
            raise ValueError(f"the row blocks must be contiguous {bs[0].dtype} tensors on {dev}")
    bw_lo, bw_hi = band(first.offsets)
    if max(bw_lo, bw_hi) > L:
        raise ValueError(f"bandwidth ({bw_lo}/{bw_hi}) exceeds the {L}-row shard")
    if not 1 <= first.ndiag <= MAX_DIAGS:
        raise ValueError(f"{first.ndiag} diagonals: K17 takes 1 to {MAX_DIAGS}")
    return dev


def solve_plain_dia(blocks, bs, x0s, *, method: str, max_iter: int, tolerance: float = 0.0):
    """Plain torch K17: the sharded recurrence of ``method`` on the plain
    dia-halo matvec (``DiaRows.matvec`` over ``BandStrips``), the ranks'
    partials summed in rank order."""
    from hpccg_tpu_torch.ops.cuda.fused_cg import cg_finalize_plain
    from hpccg_tpu_torch.parallel.halo import BandStrips
    from hpccg_tpu_torch.solver import ONE_REDUCTION, cg_solve

    blocks, bs, x0s = tuple(blocks), tuple(bs), tuple(x0s)
    first = blocks[0]
    strips = BandStrips(first.local_nrow, first.bw_lo, first.bw_hi, [v.device for v in bs], bs[0].dtype)

    def matvec(vs):
        return tuple(blk.matvec(x) for blk, x in zip(blocks, strips.fill(vs)))

    if method == "cg":
        return cg_solve(matvec, bs, x0s, max_iter=max_iter, tolerance=tolerance, finalize=cg_finalize_plain)
    return ONE_REDUCTION[method](matvec, bs, x0s, max_iter=max_iter, tolerance=tolerance)


def dia_resident_blocks(dtype, method: str) -> int:
    """K17's blocks resident at once on the current card, or minus a CUDA
    error code."""
    return load_library().hpccg_collective_dia_resident_blocks(0 if dtype == torch.float32 else 1, METHODS[method])


def dia_tile_rows() -> int:
    """The rows a block of K17 takes at a time (threads x rows per thread)."""
    return load_library().hpccg_collective_dia_block_rows()


def dia_blocks_per_rank(L: int, ndev: int, dtype, method: str) -> int:
    """K17's blocks per rank: one per tile of the rank's rows, capped by the
    card's resident blocks shared among ``ndev`` ranks."""
    resident = _resident(dia_resident_blocks(dtype, method), ndev, "collective DIA kernel")
    return min(-(-L // dia_tile_rows()), resident // ndev)


def launch_dia(blocks, bs, x0s, *, method: str, max_iter: int, tolerance: float = 0.0, wait_ns: int = WAIT_NS):
    """One cooperative launch of K17 for every rank, on the shards' card and
    the current stream; synchronises to read the error word and raises
    RuntimeError if a wait gave up. Returns a CGResult."""
    blocks, bs, x0s = tuple(blocks), tuple(bs), tuple(x0s)
    dev, dtype, ndev = bs[0].device, bs[0].dtype, len(bs)
    first = blocks[0]
    L, bw_lo, bw_hi = first.local_nrow, first.bw_lo, first.bw_hi
    bpr = dia_blocks_per_rank(L, ndev, dtype, method)
    # (phase 0/1, from below / from above, strip rows) per rank
    sc = _Scratch(bs, x0s, VECTORS[method], (2, 2, max(bw_lo, bw_hi, 1)), bpr, max_iter,
                  data=[blk.data for blk in blocks])
    offsets = torch.tensor(first.offsets, dtype=torch.int32, device=dev)
    lib = load_library()
    fn = lib.hpccg_collective_dia_f32 if dtype == torch.float32 else lib.hpccg_collective_dia_f64
    # the C entry points launch on the current device, which must be the stream's
    with torch.cuda.device(dev):
        code = fn(sc.ptrs.data_ptr(), offsets.data_ptr(), sc.trace.data_ptr(), sc.stats.data_ptr(),
                  sc.err.data_ptr(), ndev, bpr, L, first.ndiag, bw_lo, bw_hi, METHODS[method], max_iter,
                  float(tolerance), int(wait_ns), torch.cuda.current_stream(dev).cuda_stream)
    check_launch(code, "collective DIA kernel (cooperative launch)")
    return sc.result(wait_ns, f"{ndev} ranks x {bpr} blocks")


def cg_collective_dia(blocks, bs, x0s, *, method: str = "cg1", max_iter: int, tolerance: float = 0.0):
    """K17: the whole multi-rank solve of a banded matrix in one launch,
    method ``cg`` or ``cg1`` (plain on the CPU). ``blocks``: each rank's
    DiaRows; ``bs``/``x0s``: sharded vectors. Returns a CGResult with
    sharded x."""
    if method not in ("cg", "cg1"):
        raise ValueError(f"K17 runs methods cg and cg1, got {method!r}")
    dev = _check_dia(blocks, bs, x0s)
    if dev.type == "cpu":
        return solve_plain_dia(blocks, bs, x0s, method=method, max_iter=max_iter, tolerance=tolerance)
    res = launch_dia(blocks, bs, x0s, method=method, max_iter=max_iter, tolerance=tolerance)
    cg_collective_dia.launches += 1
    return res


cg_collective_dia.launches = 0
