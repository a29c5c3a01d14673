"""The port stands alone: it never imports jax, and chip_smoke.py refuses to
run without a GPU."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    return env


def test_port_modules_never_import_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import hpccg_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(hpccg_tpu_torch.__path__, 'hpccg_tpu_torch.')]\n"
        "names = [n for n in names if n != 'hpccg_tpu_torch.__main__']\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib', 'hpccg_tpu.')))\n"
        "assert 'hpccg_tpu' not in sys.modules and not bad, bad\n"
        "print(len(names))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=_env(),
                          cwd=ROOT, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 30  # every module of the slices was imported


def test_bench_and_bandwidth_never_import_jax():
    """The benchmark entry point and the bandwidth probe, imported alone."""
    code = (
        "import sys\n"
        "import hpccg_tpu_torch.bench, hpccg_tpu_torch.utils.bandwidth, hpccg_tpu_torch.ops.cuda.stream\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib', 'hpccg_tpu.')))\n"
        "assert 'hpccg_tpu' not in sys.modules and not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=_env(),
                          cwd=ROOT, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_chip_smoke_fails_without_a_gpu():
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], capture_output=True, text=True,
                          env={**_env(), "CUDA_VISIBLE_DEVICES": ""}, cwd=ROOT, timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
