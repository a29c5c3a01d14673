"""The plain versions of the port's sparse kernels against the JAX
package's Pallas kernels (interpret mode, on the CPU).

- K9 (``spmv_dia_pallas``) and K10 (``prepare_dia_dd(A).matvec``, f64 as
  (hi, lo) f32 pairs) against ``ops/cuda/dia.py::spmv_dia``'s plain version,
  on a stencil's 27 diagonals and on random bands of 200-300 diagonals;
- K11 (``spmv_gell``) and K12 (``spmv_gell_dd``) against
  ``ops/cuda/ell.py::spmv_ell``'s plain version, on a generated stencil and
  an RCM-ordered randomly permuted 16^3 stencil. The wide-scatter tiers
  K13/K14 are in test_torch_wide_scatter_kernels.py.

The wrappers are called on CPU tensors, where they run their plain versions
and count no launch. Tolerance: max|port - jax| / max|jax| within 1e-5 in
float32 and 1e-13 in float64; the double-float kernels carry about 2^-106
relative precision per product (ddmath.py), well inside 1e-13.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import hpccg_tpu  # noqa: E402
import hpccg_tpu.operators as jops  # noqa: E402
from hpccg_tpu.models.stencil import generate_ell as jgenerate_ell  # noqa: E402
from hpccg_tpu.ops.pallas.dia_kernel import prepare_dia_dd, spmv_dia_pallas  # noqa: E402
from hpccg_tpu.ops.pallas.gell_kernel import prepare_gell, spmv_gell, spmv_gell_dd  # noqa: E402
from hpccg_tpu.reorder import permute_ell, rcm_permutation  # noqa: E402
from hpccg_tpu_torch.convert import dia_from_numpy, ell_from_numpy  # noqa: E402
from hpccg_tpu_torch.ops.cuda.dia import prepare_dia, spmv_dia  # noqa: E402
from hpccg_tpu_torch.ops.cuda.ell import prepare_ell, spmv_ell  # noqa: E402

RTOL = {np.dtype(np.float32): 1e-5, np.dtype(np.float64): 1e-13}


def _close(got, want):
    got, want = got.numpy(), np.asarray(want)
    assert got.dtype == want.dtype
    err = np.max(np.abs(got - want)) / np.max(np.abs(want))
    assert err <= RTOL[want.dtype], err


def _stencil_ell(dims, dtype):
    """The JAX package's generated ELL, as a host-array EllMatrix."""
    A = jgenerate_ell(hpccg_tpu.ProblemConfig(*dims, dtype=getattr(jnp, dtype))).A
    return jops.EllMatrix(vals=np.asarray(A.vals), cols=np.asarray(A.cols), valid=np.asarray(A.valid),
                          start_row=0, total_nrow=A.local_nrow)


def _permuted_stencil(dtype, seed, rcm=False):
    """A randomly permuted 16^3 stencil (wide scatter), RCM-ordered on request."""
    A = _stencil_ell((16, 16, 16), dtype)
    Ap = permute_ell(A, np.random.default_rng(seed).permutation(A.local_nrow))
    return permute_ell(Ap, rcm_permutation(Ap)) if rcm else Ap


def _random_band(n, ndiag_draw, span, seed, dtype):
    """A random DIA band (zeros outside each diagonal), as numpy."""
    rng = np.random.default_rng(seed)
    offs = tuple(sorted({0, *(int(o) for o in rng.integers(-span, span + 1, ndiag_draw))}))
    data = np.zeros((len(offs), n))
    for d, off in enumerate(offs):
        lo, hi = max(0, -off), min(n, n - off)
        data[d, lo:hi] = 2.0 * len(offs) if off == 0 else rng.uniform(-1, -0.1, hi - lo)
    return jops.DiaMatrix(data=jnp.asarray(data.astype(dtype)), offsets=offs, total_nrow=n)


def _port_ell(jA):
    return ell_from_numpy(np.asarray(jA.vals), np.asarray(jA.cols), np.asarray(jA.valid), 0, jA.local_nrow,
                          device="cpu")


def _launches(wrapper) -> int:
    return wrapper.launches_f32 + wrapper.launches_f64


def _ell_plain(jA, x):
    before = _launches(spmv_ell)
    y = spmv_ell(prepare_ell(_port_ell(jA)), torch.from_numpy(x))
    assert _launches(spmv_ell) == before
    return y


def _dia_plain(jD, x):
    before = _launches(spmv_dia)
    D = dia_from_numpy(np.asarray(jD.data), jD.offsets, jD.total_nrow, device="cpu")
    y = spmv_dia(prepare_dia(D), torch.from_numpy(x))
    assert _launches(spmv_dia) == before
    return y


def _x(n, dtype, seed=0):
    return np.random.default_rng(seed).standard_normal(n).astype(dtype)


@pytest.mark.parametrize("case", ["stencil", "band"])
def test_k9_plain_matches_spmv_dia_pallas(case):
    """27 diagonals of 10x10x10 (n = 1000) and a random ~290-diagonal band
    at n = 4001 (neither a multiple of 128)."""
    if case == "stencil":
        jD = _stencil_ell((10, 10, 10), "float32").to_dia()
        jD = jops.DiaMatrix(data=jnp.asarray(jD.data), offsets=jD.offsets, total_nrow=jD.total_nrow)
    else:
        jD = _random_band(4001, 320, 700, seed=1, dtype=np.float32)
        assert len(jD.offsets) > 250
    x = _x(jD.local_nrow, np.float32)
    _close(_dia_plain(jD, x), spmv_dia_pallas(jD, jnp.asarray(x), interpret=True))


@pytest.mark.parametrize("case", ["stencil", "band"])
def test_k10_plain_matches_prepare_dia_dd(case):
    if case == "stencil":
        jD = _stencil_ell((9, 11, 10), "float64").to_dia()
        jD = jops.DiaMatrix(data=jnp.asarray(jD.data), offsets=jD.offsets, total_nrow=jD.total_nrow)
    else:
        jD = _random_band(1000, 230, 400, seed=2, dtype=np.float64)
        assert len(jD.offsets) > 200
    x = _x(jD.local_nrow, np.float64, seed=1)
    _close(_dia_plain(jD, x), prepare_dia_dd(jD).matvec(jnp.asarray(x)))


@pytest.mark.parametrize("case", ["stencil", "rcm_permuted"])
def test_k11_plain_matches_spmv_gell(case):
    jA = _stencil_ell((12, 10, 9), "float32") if case == "stencil" else _permuted_stencil("float32", 3, rcm=True)
    x = _x(jA.local_nrow, np.float32, seed=2)
    _close(_ell_plain(jA, x), spmv_gell(prepare_gell(jA), jnp.asarray(x), interpret=True))


def test_k12_plain_matches_spmv_gell_dd():
    jA = _stencil_ell((10, 10, 10), "float64")
    x = _x(jA.local_nrow, np.float64, seed=3)
    G = prepare_gell(jA)
    assert G.vals3lo is not None
    _close(_ell_plain(jA, x), spmv_gell_dd(G, jnp.asarray(x), interpret=True))
