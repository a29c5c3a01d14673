"""The plain version of the port's ELL gather kernel against the JAX
package's wide-scatter tiers (interpret mode, on the CPU): K13
(``spmv_gell_stack``, ``spmv_gell_stack_dd``) and K14 (``spmv_gell_dynwin``,
``spmv_gell_dynwin_dd``), which the one ELL kernel (K11/K12) computes on
Hopper. Each on its own class of matrix: a randomly permuted 16^3 stencil
and a random wide scatter; the f64 tiers at one small shape.

The wrapper is called on CPU tensors, where it runs its plain version and
counts no launch. Tolerance: max|port - jax| / max|jax| within 1e-5 in
float32 and 1e-13 in float64.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from hpccg_tpu.ops.pallas.gell_dynwin import (  # noqa: E402
    prepare_gell_dynwin,
    spmv_gell_dynwin,
    spmv_gell_dynwin_dd,
)
from hpccg_tpu.ops.pallas.gell_stack import (  # noqa: E402
    prepare_gell_stack,
    spmv_gell_stack,
    spmv_gell_stack_dd,
)
import hpccg_tpu  # noqa: E402
import hpccg_tpu.operators as jops  # noqa: E402
from hpccg_tpu.models.stencil import generate_ell as jgenerate_ell  # noqa: E402
from hpccg_tpu.reorder import permute_ell  # noqa: E402
from hpccg_tpu_torch.convert import ell_from_numpy  # noqa: E402
from hpccg_tpu_torch.ops.cuda.ell import prepare_ell, spmv_ell  # noqa: E402

RTOL = {np.dtype(np.float32): 1e-5, np.dtype(np.float64): 1e-13}


def _close(got, want):
    got, want = got.numpy(), np.asarray(want)
    assert got.dtype == want.dtype
    err = np.max(np.abs(got - want)) / np.max(np.abs(want))
    assert err <= RTOL[want.dtype], err


def _permuted_stencil(dtype, seed):
    """A randomly permuted 16^3 stencil (wide scatter), as a host-array
    EllMatrix."""
    A = jgenerate_ell(hpccg_tpu.ProblemConfig(16, 16, 16, dtype=getattr(jnp, dtype))).A
    A = jops.EllMatrix(vals=np.asarray(A.vals), cols=np.asarray(A.cols), valid=np.asarray(A.valid),
                       start_row=0, total_nrow=A.local_nrow)
    return permute_ell(A, np.random.default_rng(seed).permutation(A.local_nrow))


def _wide_scatter(n, per_row, bw, seed, dtype="float32"):
    """A random wide band (as tests/test_gell_stack.py builds it): a dominant
    diagonal slot and 15% invalid slots."""
    rng = np.random.default_rng(seed)
    cols = np.clip(np.arange(n)[:, None] + rng.integers(-bw, bw + 1, (n, per_row)), 0, n - 1)
    cols[:, 0] = np.arange(n)
    vals = rng.uniform(-1.0, -0.1, (n, per_row))
    vals[:, 0] = per_row + 1.0
    valid = np.ones((n, per_row), bool)
    valid[rng.random((n, per_row)) < 0.15] = False
    valid[:, 0] = True
    return jops.EllMatrix(vals=np.where(valid, vals, 0.0).astype(dtype), cols=cols.astype(np.int32),
                          valid=valid, start_row=0, total_nrow=n)


def _ell_plain(jA, x):
    A = ell_from_numpy(np.asarray(jA.vals), np.asarray(jA.cols), np.asarray(jA.valid), 0, jA.local_nrow,
                       device="cpu")
    before = spmv_ell.launches_f32 + spmv_ell.launches_f64
    y = spmv_ell(prepare_ell(A), torch.from_numpy(x))
    assert spmv_ell.launches_f32 + spmv_ell.launches_f64 == before
    return y


def _x(n, dtype, seed=0):
    return np.random.default_rng(seed).standard_normal(n).astype(dtype)


@pytest.mark.parametrize("case", ["permuted_stencil", "wide_scatter"])
def test_k13_plain_matches_spmv_gell_stack(case):
    jA = _permuted_stencil("float32", 4) if case == "permuted_stencil" else _wide_scatter(10000, 9, 3000, seed=1)
    S = prepare_gell_stack(jA, strip_chunks=16)
    assert len(S.strips) > 1
    x = _x(jA.local_nrow, np.float32, seed=4)
    _close(_ell_plain(jA, x), spmv_gell_stack(S, jnp.asarray(x), interpret=True))


@pytest.mark.parametrize("case", ["permuted_stencil", "wide_scatter"])
def test_k14_plain_matches_spmv_gell_dynwin(case):
    jA = _permuted_stencil("float32", 5) if case == "permuted_stencil" else _wide_scatter(10000, 9, 3000, seed=2)
    D = prepare_gell_dynwin(jA, K=16)
    x = _x(jA.local_nrow, np.float32, seed=5)
    _close(_ell_plain(jA, x), spmv_gell_dynwin(D, jnp.asarray(x), interpret=True))


def test_k13_k14_f64_plain_matches_dd_tiers():
    jA = _wide_scatter(4096, 5, 1500, seed=11, dtype="float64")
    x = _x(jA.local_nrow, np.float64, seed=6)
    want = _ell_plain(jA, x)
    S = prepare_gell_stack(jA, strip_chunks=8)
    D = prepare_gell_dynwin(jA, K=8)
    assert S.vals3lo is not None and D.vals4lo is not None
    _close(want, spmv_gell_stack_dd(S, jnp.asarray(x), interpret=True))
    _close(want, spmv_gell_dynwin_dd(D, jnp.asarray(x), interpret=True))
