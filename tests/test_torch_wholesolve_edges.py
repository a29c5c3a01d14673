"""The whole solves K5 (``megakernel``) and K6 (``streamkernel``) on grids at
the edges of the CUDA kernel's tile, against the JAX package's whole-solve
Pallas kernels, on the CPU.

The CUDA kernel (``csrc/wholesolve.cu``) marches K3's staged tile: 16 bytes
of a row a thread (V = 4 points in float32, 2 in float64, 8 in bfloat16), a
tile 32 V points wide and 8 rows high, and work items of a z chunk of up to
32 planes, chosen per grid; ``tests/test_torch_cuda.py`` holds it against
its plain version on grids that cross those edges. Here the plain versions,
which the wrappers run on the CPU, are held against ``cg_mega_padded``
(whole and slab) and ``cg_stream_padded`` in interpret mode on small grids
of the same kinds: nx below V, nx = 100, nx one below and one above the
tile width, ny not a multiple of 8, nz one below and one above a chunk of
32 or 16 planes.

``test_plane_dot_sums_plane_by_plane`` pins the dot products that the
kernel and its plain version share (``wholesolve.plane_dot``).

Tolerances as in ``tests/test_torch_wholesolve.py``: float64 niters equal,
trace rtol 1e-10 above 1e-11 * trace[0], x rtol 1e-12; float32 trace rtol
1e-4 above 1e-5 * trace[0]; bfloat16 niters equal, max|x - 1| < 0.1, the
trace within 5e-2 above 1e-3 * trace[0] (the port computes in f32 and
rounds where it stores, the TPU kernels round every elementwise step).
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from hpccg_tpu_torch import make_cg  # noqa: E402
from hpccg_tpu_torch.ops.cuda.wholesolve import plane_dot  # noqa: E402

from test_torch_wholesolve import MODES, _head, _jax_solve, _problems  # noqa: E402

# (label, dtype, (nx, ny, nz), stencil)
CASES = [
    ("nx<V", "float32", (3, 11, 5), 27),
    ("nx=100", "float32", (100, 9, 7), 7),
    ("nx=TX-1", "float32", (127, 9, 6), 27),
    ("nx=TX+1", "float32", (129, 17, 5), 7),
    ("ny%TY", "float32", (33, 29, 9), 27),
    ("nz=ZC-1", "float32", (20, 9, 31), 27),
    ("nz=ZC+1", "float32", (20, 9, 33), 7),
    ("nx<V", "float64", (1, 11, 5), 27),
    ("nx=TX-1", "float64", (63, 9, 6), 7),
    ("nx=TX+1,nz=ZC+1", "float64", (65, 9, 17), 27),
    ("nx<V", "bfloat16", (7, 11, 5), 27),
    ("nx=TX-1", "bfloat16", (255, 9, 6), 7),
    ("nx=TX+1", "bfloat16", (257, 9, 5), 27),
    ("nx=100,nz=ZC-1", "bfloat16", (100, 9, 15), 27),
]
IDS = [f"{c[0]}-{c[1]}-{c[2][0]}x{c[2][1]}x{c[2][2]}-{c[3]}pt" for c in CASES]


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_whole_solve_at_tile_edges_matches_jax(case, mode):
    _, dtype, dims, stencil = case
    jprob, prob = _problems(dims, stencil, dtype)
    max_iter = 15 if dtype == "bfloat16" and stencil == 7 else 30
    jx, jt, jn, _ = _jax_solve(mode, jprob, max_iter)
    res = make_cg(prob.A, max_iter=max_iter, backend=MODES[mode])(prob.b, prob.x0)
    assert res.x.dtype == getattr(torch, dtype)
    t = res.trace.float().numpy() if dtype == "bfloat16" else res.trace.numpy()
    rtol, head = _head(jt.astype(np.float32) if dtype == "bfloat16" else jt, dtype)
    assert head[:3].all()
    np.testing.assert_allclose(t[head], jt[head], rtol=rtol)
    if dtype == "float64":
        assert int(res.niters) == jn == max_iter - 1
        np.testing.assert_allclose(res.x.numpy(), jx, rtol=1e-12)
    if dtype == "bfloat16":
        assert int(res.niters) == jn == max_iter - 1
        assert float((res.x.float() - 1).abs().max()) < 0.1


@pytest.mark.parametrize("vdt, sdt", [(torch.float32, torch.float32), (torch.float64, torch.float64),
                                      (torch.bfloat16, torch.float32)], ids=["f32", "f64", "bf16"])
def test_plane_dot_sums_plane_by_plane(vdt, sdt):
    """plane_dot: each z-plane's products, rounded to the scalar dtype, summed
    in float64 and rounded once; the plane sums added in the scalar dtype in
    z order. With float32 scalars a plane's sum is the exact one rounded
    (math.fsum here), and a permutation within each plane (the kernel sums
    a plane in another order) gives the same bits; with float64 scalars the
    float64 sums are within 1e-13 of it. Either is within rounding of
    torch.dot."""
    nz, plane = 9, 37
    rng = np.random.default_rng(19)
    u = torch.from_numpy(rng.standard_normal(nz * plane) * 10.0 ** rng.integers(-6, 6, nz * plane)).to(vdt)
    v = torch.from_numpy(rng.standard_normal(nz * plane)).to(vdt)
    got = plane_dot(u, v, nz, sdt)
    assert got.shape == (1,) and got.dtype == sdt
    np_s = np.float32 if sdt == torch.float32 else np.float64
    prods = (u.to(sdt) * v.to(sdt)).numpy().reshape(nz, plane)
    acc = np_s(0)
    for row in prods:
        acc = np_s(acc + np_s(math.fsum(row.astype(np.float64))))
    perm = torch.cat([torch.randperm(plane, generator=torch.Generator().manual_seed(z)) + z * plane
                      for z in range(nz)])
    if sdt == torch.float32:
        assert got.numpy()[0] == acc
        assert torch.equal(plane_dot(u[perm], v[perm], nz, sdt), got)
    else:
        np.testing.assert_allclose(got.numpy()[0], acc, rtol=1e-13)
        np.testing.assert_allclose(plane_dot(u[perm], v[perm], nz, sdt).numpy(), got.numpy(), rtol=1e-13)
    np.testing.assert_allclose(float(got[0]), float(torch.dot(u.to(sdt), v.to(sdt))),
                               rtol=1e-5 if sdt == torch.float32 else 1e-13)
