"""The port's StencilOperator against the JAX package's and the NumPy oracle."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from hpccg_tpu.config import Stencil as JStencil  # noqa: E402
from hpccg_tpu.operators import StencilOperator as JStencilOperator  # noqa: E402
from hpccg_tpu_torch.config import Stencil  # noqa: E402
from hpccg_tpu_torch.operators import StencilOperator, stencil_offsets  # noqa: E402
from hpccg_tpu.operators import stencil_offsets as jstencil_offsets  # noqa: E402

from oracle import oracle_matrix  # noqa: E402

# non-cubic grids, a grid one cell thick in each axis, 27- and 7-point
GRIDS = [
    (9, 5, 7, 27), (9, 5, 7, 7), (6, 1, 4, 27), (6, 1, 4, 7),
    (1, 4, 3, 27), (5, 3, 1, 7), (12, 10, 9, 27),
]
# relative to max|y|: the sums associate as in the JAX package, so f64 is
# exact up to cancellation near zero, and f32 within a few ulps
RTOL = {"float64": 1e-14, "float32": 1e-6}


def _ops(nx, ny, nz, st, dtype):
    return (
        StencilOperator(nx, ny, nz, Stencil(st), getattr(torch, dtype)),
        JStencilOperator(nx, ny, nz, JStencil(st), dtype),
    )


def _close(got, want, rtol):
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * np.abs(want).max())


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("dims", GRIDS)
def test_matvec_matches_jax(dims, dtype):
    nx, ny, nz, st = dims
    op, jop = _ops(nx, ny, nz, st, dtype)
    x = np.random.default_rng(0).standard_normal(nx * ny * nz).astype(dtype)
    got = op.matvec(torch.from_numpy(x)).numpy()
    want = np.asarray(jop.matvec(jnp.asarray(x)))
    assert got.dtype == want.dtype
    _close(got, want, RTOL[dtype])


@pytest.mark.parametrize("dims", GRIDS)
def test_matvec_nnz_match_oracle(dims):
    nx, ny, nz, st = dims
    op, jop = _ops(nx, ny, nz, st, "float64")
    rows, cols, vals, b, _ = oracle_matrix(nx, ny, nz, seven_pt=(st == 7))
    x = np.random.default_rng(1).standard_normal(nx * ny * nz)
    want = np.zeros_like(x)
    np.add.at(want, rows, vals * x[cols])
    _close(op.matvec(torch.from_numpy(x)).numpy(), want, RTOL["float64"])
    assert op.nnz == len(vals) == jop.nnz
    assert op.nnz_model == st * nx * ny * nz == jop.nnz_model


def test_stencil_offsets_match_jax():
    for st in (27, 7):
        assert stencil_offsets(Stencil(st)) == jstencil_offsets(JStencil(st))


def test_operator_is_metadata_only():
    op = StencilOperator(4, 3, 2)
    assert op.local_nrow == 24 and op.dtype == torch.float64
    with pytest.raises(Exception):
        op.nx = 5  # frozen
