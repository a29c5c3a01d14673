"""The port's benchmark entry point, ``python -m hpccg_tpu_torch.bench``, on
the CPU: one JSON line with the JAX bench's keys (``bench.py:216-242``)
plus the port's, its presets, and its solve against the JAX package's.

The problem is 16^3 float64 on ``stencil`` with max_iter 20: at 8^3 the
20-iteration residual (5e-17) is below the sum-order floor, where the two
packages' traces part by percents, while at 16^3 it is 3.6e-4 and the two
agree to 6e-14. The run takes about 6 s.
"""

import io
import json
import math
import os
import subprocess
import sys
from contextlib import redirect_stdout
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import hpccg_tpu  # noqa: E402
from hpccg_tpu.solver import make_cg as jmake_cg  # noqa: E402
from hpccg_tpu_torch import bench  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARGS = ["--device", "cpu", "--nx", "16", "--ny", "16", "--nz", "16", "--dtype", "float64", "--max-iter", "20",
        "--reps", "3", "--backend", "stencil"]
JAX_KEYS = ("device", "backend", "problem", "niters", "cg_iter_us", "spmv_us", "spmv_gbps_2pass",
            "spmv_gnnz_per_s", "cg_iters_per_s", "solve_e2e_s", "mflops_model", "final_normr", "timing",
            "other_paths", "vs_baseline_def")
PORT_KEYS = ("power_limit_w", "hbm_copy_gbps", "hbm_write_gbps")


@pytest.fixture(scope="module")
def line():
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert bench.main(ARGS) == 0
    lines = [ln for ln in buf.getvalue().splitlines() if ln.strip()]
    assert len(lines) == 1
    return json.loads(lines[0])


def test_bench_prints_one_line_with_the_keys(line):
    for key in ("metric", "value", "unit", "vs_baseline", "extras"):
        assert key in line
    assert line["unit"] == "Gnnz/s"
    for key in JAX_KEYS + PORT_KEYS:
        assert key in line["extras"], key
    ex = line["extras"]
    assert ex["device"] == "cpu" and ex["power_limit_w"] is None and ex["backend"] == "stencil"
    assert ex["problem"] == "16x16x16 27-pt float64"


def test_bench_numbers(line):
    ex = line["extras"]
    assert ex["niters"] == 19
    for key in ("cg_iter_us", "spmv_us", "solve_e2e_s", "hbm_copy_gbps", "hbm_write_gbps"):
        assert math.isfinite(ex[key]) and ex[key] > 0, key
    assert math.isfinite(line["value"]) and line["value"] > 0
    # value = nnz_model / t_iter; vs_baseline = nnz/s over (copy rate / 12 B)
    nnz = 27 * 16**3
    assert math.isclose(line["value"], nnz / (ex["cg_iter_us"] * 1e-6) / 1e9, rel_tol=1e-9)
    assert math.isclose(line["vs_baseline"], line["value"] * 12.0 / ex["hbm_copy_gbps"], rel_tol=1e-9)
    assert "hbm_copy_gbps" in ex["vs_baseline_def"] and "measured on this device" in ex["vs_baseline_def"]


def test_bench_other_paths_carry_no_figures(line):
    """The JAX line's other_paths is all TPU figures; the port's names the
    paths and points to PERF.md."""
    text = line["extras"]["other_paths"]
    assert "PERF.md" in text and not any(c.isdigit() for c in text)


def test_bench_final_normr_matches_jax(line):
    jprob = hpccg_tpu.generate_problem(hpccg_tpu.ProblemConfig(16, 16, 16, dtype=jnp.float64))
    jres = jmake_cg(jprob.A, max_iter=20, tolerance=0.0, backend="stencil")(jprob.b, jprob.x0)
    assert math.isclose(line["extras"]["final_normr"], float(jres.normr), rel_tol=1e-10)


@pytest.mark.parametrize("preset", sorted(bench.PRESETS))
def test_presets_set_the_grid(preset, capsys):
    args = bench.build_argparser().parse_args(["--preset", preset, "--nx", "8"])
    bench.apply_preset(args)
    side, stencil = {"parity32": (32, 27), "fused64": (64, 7), "headline100": (100, 27), "weak-unit": (100, 27),
                     "strong256": (256, 27)}[preset]
    assert (args.nx, args.ny, args.nz, args.stencil) == (side, side, side, stencil)
    assert "--preset overrides" in capsys.readouterr().err


def test_bench_refuses_a_missing_card():
    """The default device is the card: without one the module exits 2 and
    prints no result line."""
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": "", "PYTHONPATH": str(ROOT) + os.pathsep
           + os.environ.get("PYTHONPATH", "")}
    proc = subprocess.run([sys.executable, "-m", "hpccg_tpu_torch.bench", "--preset", "parity32"],
                          capture_output=True, text=True, env=env, cwd=ROOT, timeout=120)
    assert proc.returncode == 2 and proc.stdout == ""
    assert "no CUDA device" in proc.stderr
