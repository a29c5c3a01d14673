"""The bandwidth probes of ``exp/`` and their counterparts in the port, on
the CPU.

``exp/stream_probe.py`` and ``exp/rw_probe.py`` run their probes when they
are imported, so the port's probes (``ops/cuda/stream.py``; their plain
versions here) are held against numpy at those scripts' shapes: y = x + 1
over (264, 256, 256) float32, and o = tile(seed) * 1.00001 over (262144,
128) float32 from a (512, 128) seed. Both are exact (one float32 operation
per element). ``utils/bandwidth.measure`` runs the plain versions at a size
given on the CPU.

``exp/dynwin_probe.py::spmv_dyn`` (the dynamic-window ELL SpMV, K14's
prototype) runs in interpret mode on a randomly permuted 8^3 stencil and is
held against the port's ELL matvec (K11's plain version) within 1e-5 of
max|y|: K11 computes what it computes. The CUDA probe kernels against their
plain versions: ``tests/test_torch_cuda.py``.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import hpccg_tpu  # noqa: E402
from hpccg_tpu.models.stencil import generate_ell as jgenerate_ell  # noqa: E402
from hpccg_tpu.reorder import permute_ell as jpermute_ell  # noqa: E402
from hpccg_tpu_torch import ProblemConfig  # noqa: E402
from hpccg_tpu_torch.models.stencil import generate_ell  # noqa: E402
from hpccg_tpu_torch.ops.cuda import ell as cell  # noqa: E402
from hpccg_tpu_torch.ops.cuda import stream  # noqa: E402
from hpccg_tpu_torch.reorder import permute_ell  # noqa: E402
from hpccg_tpu_torch.utils import bandwidth  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
COPY_SHAPE = (264, 256, 256)  # exp/stream_probe.py:15
WRITE_ROWS, SEED_SHAPE = 262144, (512, 128)  # exp/rw_probe.py:13-14


def test_copy_probe_plain_matches_numpy():
    x = np.random.default_rng(0).standard_normal(COPY_SHAPE).astype(np.float32)
    before = stream.copy_plus_one.launches
    y = stream.copy_plus_one(torch.from_numpy(x))
    assert y.dtype == torch.float32 and tuple(y.shape) == COPY_SHAPE
    np.testing.assert_array_equal(y.numpy(), x + np.float32(1))
    out = torch.empty(COPY_SHAPE)
    assert stream.copy_plus_one(torch.from_numpy(x), out=out) is out
    np.testing.assert_array_equal(out.numpy(), x + np.float32(1))
    assert stream.copy_plus_one.launches == before  # the CPU runs the plain version


def test_write_probe_plain_matches_numpy():
    seed = np.random.default_rng(1).standard_normal(SEED_SHAPE).astype(np.float32)
    n = WRITE_ROWS * SEED_SHAPE[1]
    before = stream.write_tiled.launches
    o = stream.write_tiled(torch.from_numpy(seed), n)
    want = np.tile(seed, (WRITE_ROWS // SEED_SHAPE[0], 1)) * np.float32(1.00001)
    np.testing.assert_array_equal(o.numpy().reshape(WRITE_ROWS, SEED_SHAPE[1]), want)
    # a length that is not a whole number of tiles
    o = stream.write_tiled(torch.from_numpy(seed), 1000003)
    np.testing.assert_array_equal(o.numpy(), want.reshape(-1)[:1000003])
    assert stream.write_tiled.launches == before


def test_probe_wrappers_refuse_what_the_kernels_do_not_take():
    with pytest.raises(TypeError):
        stream.copy_plus_one(torch.zeros(8, dtype=torch.float64))
    with pytest.raises(ValueError):
        stream.copy_plus_one(torch.zeros(8), out=torch.zeros(9))
    with pytest.raises(ValueError, match="multiple of 4"):
        stream.write_tiled(torch.zeros(6), 12)
    with pytest.raises(ValueError):
        stream.write_tiled(torch.zeros(8), 12, out=torch.zeros(13))


def test_bandwidth_measure_on_the_cpu():
    bw = bandwidth.measure("cpu", 4 << 20, reps=3)
    assert bw.device == "cpu" and bw.nbytes == 4 << 20
    assert np.isfinite(bw.copy_gbps) and bw.copy_gbps > 0
    assert np.isfinite(bw.write_gbps) and bw.write_gbps > 0
    with pytest.raises(ValueError, match="nbytes"):
        bandwidth.measure("cpu")
    with pytest.raises(ValueError, match="seed tile"):
        bandwidth.measure("cpu", 1000)


def _dynwin_probe():
    spec = importlib.util.spec_from_file_location("dynwin_probe", ROOT / "exp" / "dynwin_probe.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("K", [16, 24])
def test_dynwin_probe_matches_the_ell_kernel(K):
    probe = _dynwin_probe()
    n = 8**3
    perm = np.random.default_rng(2).permutation(n)
    jA = jpermute_ell(jgenerate_ell(hpccg_tpu.ProblemConfig(8, 8, 8, dtype=jnp.float32)).A, perm)
    A = permute_ell(generate_ell(ProblemConfig(8, 8, 8, dtype=torch.float32), "cpu").A, perm)
    x = np.random.default_rng(3).standard_normal(n).astype(np.float32)
    prep = probe.prep_dynwin(jA, K=K)
    assert prep is not None
    want = np.asarray(probe.spmv_dyn(prep, jnp.asarray(x), n, K))
    got = cell.spmv_ell(cell.prepare_ell(A), torch.from_numpy(x)).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
