"""The plain reference against the port's plain CPU path at tiny sizes,
and the float32 control, which the comparison must fail."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from hpcbench import check, inputs, reference
from hpcbench.control import reference_runner
from hpcbench.reference.cg import cg

from conftest import TINY_LIMITS


def _problem(form, ordering, grid=(9, 7, 6), seed=2**31 + 5, rhs=2):
    config = {"name": "t", "form": form, "dtype": "float64", "reference": "csr" if form == "arrays" else "stencil27"}
    traffic = {"grid": grid, "ordering": ordering, "rhs": rhs, "x_low": 0.5, "x_high": 1.5}
    return config, inputs.make(config, traffic, seed, "cpu")


def test_inputs_repeat_for_a_seed_and_differ_between_seeds():
    _, a = _problem("arrays", "random_symmetric")
    _, b = _problem("arrays", "random_symmetric")
    _, c = _problem("arrays", "random_symmetric", seed=7)
    assert all(np.array_equal(u, v) for u, v in zip(a.ell, b.ell))
    assert all(torch.equal(u, v) for u, v in zip(a.rhs, b.rhs))
    assert not np.array_equal(a.ell[1], c.ell[1])
    assert a.nnz == c.nnz and a.n == c.n


def test_stencil_and_csr_matvecs_agree():
    _, p = _problem("arrays", "natural")
    x = torch.rand(p.n, dtype=torch.float64)
    a = reference.matvec("stencil27", p, torch.float64, "cpu")(x)
    b = reference.matvec("csr", p, torch.float64, "cpu")(x)
    torch.testing.assert_close(a, b, rtol=0, atol=1e-12)


@pytest.mark.parametrize("grid", [(8, 8, 8), (9, 7, 6), (12, 10, 11)])
def test_reference_follows_the_port_on_the_stencil(grid):
    from hpccg_tpu_torch.operators import StencilOperator
    from hpccg_tpu_torch.solver import make_cg

    _, p = _problem("operator", "natural", grid)
    A = reference.matvec("stencil27", p, torch.float64, "cpu")
    solve = make_cg(StencilOperator(*grid), max_iter=20, tolerance=0.0, backend="stencil")
    for b in p.rhs:
        res, ref = solve(b, p.x0), cg(A, b, p.x0, max_iter=20)
        solves = [(0, int(res.niters), float(res.normr), res.trace)]
        verdict = check.compare(solves, [ref], [(0, 0, res.x)], TINY_LIMITS)
        assert verdict["correct"], verdict["numbers"]
        assert ref["niters"] == 19 and int(res.niters) == 19


@pytest.mark.parametrize("ordering", ["natural", "random_symmetric"])
def test_reference_follows_the_port_on_explicit_matrices(ordering):
    """The port's structure chooser may permute; x goes back to the input's
    basis before it is judged."""
    from hpccg_tpu_torch.convert import ell_from_numpy
    from hpccg_tpu_torch.reorder import auto_structure
    from hpccg_tpu_torch.solver import make_cg

    _, p = _problem("arrays", ordering, (10, 9, 8))
    op, perm, report = auto_structure(ell_from_numpy(*p.ell, device="cpu"))
    assert (perm is None) == (ordering == "natural")
    index = None if perm is None else torch.from_numpy(perm)
    solve = make_cg(op, max_iter=20, tolerance=0.0)
    A = reference.matvec("csr", p, torch.float64, "cpu")
    for b in p.rhs:
        res = solve(b if index is None else b[index], p.x0)
        x = res.x
        if index is not None:
            x = torch.empty_like(res.x)
            x[index] = res.x
        ref = cg(A, b, p.x0, max_iter=20)
        verdict = check.compare([(0, int(res.niters), float(res.normr), res.trace)], [ref], [(0, 0, x)],
                                TINY_LIMITS)
        assert verdict["correct"], verdict["numbers"]
        if index is not None:  # left in the solve's basis, x fails
            assert check.x_gap(res.x, ref["x"]) > 1e-3


@pytest.mark.parametrize("form", ["operator", "arrays"])
def test_float32_control_fails_the_comparison(form):
    config, p = _problem(form, "natural", (12, 10, 11))
    config.update(max_iter=20, tolerance=0.0)
    runner = reference_runner(config, p, "cpu")
    A = reference.matvec(config["reference"], p, torch.float64, "cpu")
    solves, samples, refs = [], [], []
    for k, b in enumerate(p.rhs):
        res = runner.solve(k)
        solves.append((k, int(res.niters), float(res.normr), res.trace))
        samples.append((k, k, res.x))
        refs.append(cg(A, b, p.x0, max_iter=20))
    verdict = check.compare(solves, refs, samples, TINY_LIMITS)
    assert not verdict["correct"]
    numbers = {name: n["value"] for name, n in verdict["numbers"].items()}
    assert numbers["x_rel"] > 1e-8 and numbers["trace_rel"] > 1e-8 and numbers["normr_rel"] > 1e-8
