"""The port's problem generator against hpccg_tpu.generate_problem: b, x0
and xexact are small integers, so they must agree exactly."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import hpccg_tpu  # noqa: E402
import hpccg_tpu_torch  # noqa: E402

CASES = [(9, 5, 7, 27), (9, 5, 7, 7), (6, 1, 4, 27), (1, 1, 1, 27), (10, 10, 10, 27), (5, 3, 1, 7)]


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("dims", CASES)
def test_generate_matches_jax(dims, dtype):
    nx, ny, nz, st = dims
    jprob = hpccg_tpu.generate_problem(
        hpccg_tpu.ProblemConfig(nx, ny, nz, stencil=st, dtype=getattr(jnp, dtype))
    )
    prob = hpccg_tpu_torch.generate_problem(
        hpccg_tpu_torch.ProblemConfig(nx, ny, nz, stencil=st, dtype=getattr(torch, dtype)), "cpu"
    )
    for name in ("b", "x0", "xexact"):
        got, want = getattr(prob, name).numpy(), np.asarray(getattr(jprob, name))
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    assert prob.total_nrow == jprob.total_nrow == prob.local_nrow
    assert prob.total_nnz_model == jprob.total_nnz_model
    assert prob.total_nnz_exact == jprob.total_nnz_exact


@pytest.mark.parametrize("dims", CASES)
def test_generate_matches_jax_bf16(dims):
    """b = A 1 is exact in bf16 (integers up to 28): bit for bit JAX's."""
    nx, ny, nz, st = dims
    jprob = hpccg_tpu.generate_problem(hpccg_tpu.ProblemConfig(nx, ny, nz, stencil=st, dtype=jnp.bfloat16))
    prob = hpccg_tpu_torch.generate_problem(
        hpccg_tpu_torch.ProblemConfig(nx, ny, nz, stencil=st, dtype=torch.bfloat16), "cpu"
    )
    for name in ("b", "x0", "xexact"):
        got, want = getattr(prob, name), np.asarray(getattr(jprob, name))
        assert got.dtype == torch.bfloat16 and want.dtype.name == "bfloat16", name
        np.testing.assert_array_equal(got.view(torch.int16).numpy(), want.view(np.int16), err_msg=name)
    assert prob.total_nnz_exact == jprob.total_nnz_exact


def test_problem_config_rejects_bad_input():
    with pytest.raises(ValueError):
        hpccg_tpu_torch.ProblemConfig(0, 2, 2)
    with pytest.raises(ValueError):
        hpccg_tpu_torch.ProblemConfig(2, 2, 2, dtype=torch.float16)
    assert hpccg_tpu_torch.ProblemConfig(2, 2, 2, stencil=7).stencil == hpccg_tpu_torch.Stencil.S7
    assert hpccg_tpu_torch.SolverConfig().max_iter == hpccg_tpu.SolverConfig().max_iter
