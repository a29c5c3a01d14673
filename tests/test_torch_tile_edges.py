"""K1-K4 on grids at the edges of the CUDA stencil kernels' tile, against
the JAX package's Pallas kernels, on the CPU.

The CUDA kernels (``csrc/stencil.cu``, ``csrc/fused_cg.cu``) give each
thread 16 bytes of a row (V = 4 points in float32, 2 in float64, 8 in
bfloat16), a tile 32 V points wide and 8 rows high, and a block at most 32
z-planes; ``tests/test_torch_cuda.py`` holds them against their plain
versions on grids that cross those edges. Here the plain versions, which
the wrappers run on the CPU, are held against the Pallas kernels in
interpret mode on grids of the same kinds: nx below V, nx = 100, nx one
below and one above the tile width, ny not a multiple of 8, nz one below
and one above 32.

Tolerances as in ``test_torch_kernels.py`` (float32/float64: max |port -
jax| over max |jax| 1e-5 / 1e-13, dots 1e-4 / 1e-12) and
``test_torch_bf16_kernels.py`` (bfloat16: vectors 2^-6 of max|y|, dots 5% +
1: JAX keeps K3/K4 in bf16, the port computes in f32 and rounds where it
stores).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from hpccg_tpu.config import Stencil as JStencil  # noqa: E402
from hpccg_tpu.operators import StencilOperator as JStencilOperator  # noqa: E402
from hpccg_tpu.ops.pallas.fused_cg import fused_update_p_apply, fused_update_x_r  # noqa: E402
from hpccg_tpu.ops.pallas.stencil_kernel import pad_plane, plane_masks, unpad_plane  # noqa: E402
from hpccg_tpu.ops.pallas.stencil_v2 import (  # noqa: E402
    pad_plane3,
    padded_dims,
    spmv_padded_v2,
    spmv_padded_v2_pap,
    unpad_plane3,
)
from hpccg_tpu_torch.config import Stencil  # noqa: E402
from hpccg_tpu_torch.operators import StencilOperator  # noqa: E402
from hpccg_tpu_torch.ops.cuda import fused_cg as fc  # noqa: E402
from hpccg_tpu_torch.ops.cuda import stencil as st  # noqa: E402

VEC_RTOL = {"float64": 1e-13, "float32": 1e-5, "bfloat16": 2.0**-6}
DOT_RTOL = {"float64": 1e-12, "float32": 1e-4}
BETA, ALPHA = 0.375, 0.1875  # exact in bf16

# (label, dtype, (nx, ny, nz), stencil)
CASES = [
    ("nx<V", "float32", (3, 11, 5), 27),
    ("nx=100", "float32", (100, 9, 7), 7),
    ("nx=TX-1", "float32", (127, 9, 6), 27),
    ("nx=TX+1", "float32", (129, 17, 5), 7),
    ("nz=ZC-1", "float32", (33, 29, 31), 27),
    ("nz=ZC+1", "float32", (20, 9, 33), 7),
    ("nx<V", "float64", (1, 11, 5), 27),
    ("nx=TX-1", "float64", (63, 9, 6), 7),
    ("nx=TX+1", "float64", (65, 17, 5), 27),
    ("nz=ZC+1", "float64", (33, 13, 33), 7),
    ("nx<V", "bfloat16", (7, 11, 5), 27),
    ("nx=TX-1", "bfloat16", (255, 9, 6), 7),
    ("nx=TX+1", "bfloat16", (257, 9, 5), 27),
    ("nx=100,nz=ZC+1", "bfloat16", (100, 9, 33), 7),
]
IDS = [f"{c[0]}-{c[1]}-{c[2][0]}x{c[2][1]}x{c[2][2]}-{c[3]}pt" for c in CASES]


def _jdtype(dtype):
    return jnp.bfloat16 if dtype == "bfloat16" else dtype


def _t(x, dtype, shape=None):
    t = torch.from_numpy(x.copy()).to(getattr(torch, dtype))
    return t if shape is None else t.view(*shape)


def _j(x, dtype):
    return jnp.asarray(x, _jdtype(dtype))


def _vec(got, want, dtype):
    got = got.double().numpy().reshape(-1)
    want = np.asarray(want).astype(np.float64).reshape(-1)
    scale = np.abs(want).max() or 1.0
    assert np.abs(got - want).max() <= VEC_RTOL[dtype] * scale


def _dot(got, want, dtype):
    got, want = float(got), float(want)
    if dtype == "bfloat16":
        assert abs(got - want) < 0.05 * abs(want) + 1.0
    else:
        np.testing.assert_allclose(got, want, rtol=DOT_RTOL[dtype])


def _halo(jop, planes, dtype, v2):
    """(k, ny, nx) planes -> the v2 (k, ny_pad, nx_pad) or v1 (k, M) halo."""
    if v2:
        _, nyp, nxp = padded_dims(jop, _jdtype(dtype))
        h = np.zeros((planes.shape[0], nyp, nxp), planes.dtype)
        h[:, : jop.ny, : jop.nx] = planes
    else:
        h = np.zeros((planes.shape[0], plane_masks(jop, _jdtype(dtype)).shape[1]), planes.dtype)
        h[:, : jop.ny * jop.nx] = planes.reshape(planes.shape[0], -1)
    return _j(h, dtype)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_k1_k4_at_tile_edges(case):
    """K1 and K2 (with halo planes), K3 (with and without) and K4 against
    stencil_v2 and fused_cg on one grid."""
    _, dtype, (nx, ny, nz), stencil = case
    op = StencilOperator(nx, ny, nz, Stencil(stencil), getattr(torch, dtype))
    jop = JStencilOperator(nx, ny, nz, JStencil(stencil), _jdtype(dtype))
    grid, n = (nz, ny, nx), nx * ny * nz
    npdt = np.float64 if dtype == "float64" else np.float32  # bf16: rounded alike on both sides
    rng = np.random.default_rng(nx * 1000 + nz)
    x, r, p, ap = (rng.standard_normal(n).astype(npdt) for _ in range(4))
    h2, h4 = rng.standard_normal((2, ny, nx)).astype(npdt), rng.standard_normal((4, ny, nx)).astype(npdt)
    sdt = torch.float64 if dtype == "float64" else torch.float32

    u = pad_plane3(jop, _j(x, dtype))
    jh2 = _halo(jop, h2, dtype, v2=True)
    _vec(st.spmv_stencil(op, _t(x, dtype, grid), _t(h2, dtype)), unpad_plane3(jop, spmv_padded_v2(jop, u, jh2)),
         dtype)
    y_j, pap_j = spmv_padded_v2_pap(jop, u, jh2)
    y, parts = st.spmv_stencil_pap(op, _t(x, dtype, grid), _t(h2, dtype))
    _vec(y, unpad_plane3(jop, y_j), dtype)
    _dot(parts.sum(), pap_j, dtype)

    masks = jnp.asarray(plane_masks(jop, _jdtype(dtype)))
    for halo in (None, h4):
        pp_j, app_j, pap_j = fused_update_p_apply(
            jop, pad_plane(jop, _j(r, dtype)), pad_plane(jop, _j(p, dtype)), jnp.asarray(BETA, _jdtype(dtype)),
            masks, None if halo is None else _halo(jop, halo, dtype, v2=False))
        pp, app, parts = st.update_p_apply(op, _t(r, dtype, grid), _t(p, dtype, grid),
                                           torch.tensor([BETA], dtype=sdt), None if halo is None else _t(halo, dtype))
        _vec(pp, unpad_plane(jop, pp_j), dtype)
        _vec(app, unpad_plane(jop, app_j), dtype)
        _dot(parts.sum(), pap_j, dtype)

    x_j, r_j, rr_j = fused_update_x_r(*(pad_plane(jop, _j(v, dtype)) for v in (x, r, p, ap)),
                                      jnp.asarray(ALPHA, _jdtype(dtype)))
    xt, rt = _t(x, dtype), _t(r, dtype)
    _, _, parts = fc.update_x_r(xt, rt, _t(p, dtype), _t(ap, dtype), torch.tensor([ALPHA], dtype=sdt))
    _vec(xt, unpad_plane(jop, x_j), dtype)
    _vec(rt, unpad_plane(jop, r_j), dtype)
    _dot(parts.sum(), rr_j, dtype)
