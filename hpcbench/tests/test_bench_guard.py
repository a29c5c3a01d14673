"""The import guard, and the reference's independence from the program."""

from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

import pytest

from hpcbench import run

ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.parametrize("name,caught", [("jax", True), ("jax.numpy", True), ("jaxlib.xla_client", True),
                                         ("flax", True), ("hpccg_tpu", True), ("hpccg_tpu.solver", True),
                                         ("hpccg_tpu_torch", False), ("hpccg_tpu_torch.solver", False),
                                         ("jaxtyping", False), ("hpccg_tpux", False)])
def test_guard_compares_whole_top_level_names(name, caught, monkeypatch):
    monkeypatch.setitem(sys.modules, name, sys)
    assert (name in run.forbidden_modules()) == caught


def _imports(path: Path) -> set:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


def test_reference_imports_nothing_of_the_program():
    files = sorted((ROOT / "hpcbench" / "reference").glob("*.py"))
    assert files
    for path in files:
        assert not _imports(path) & {"hpccg_tpu_torch", "hpccg_tpu", "jax", "jaxlib"}, path
    code = ("import sys, hpcbench.reference as r, hpcbench.reference.cg, hpcbench.reference.csr, "
            "hpcbench.reference.stencil27; print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    loaded = set(eval(out.stdout))
    assert not loaded & {"hpccg_tpu_torch", "hpccg_tpu", "jax", "jaxlib", "flax"}


def test_no_benchmark_file_imports_jax():
    for path in (ROOT / "hpcbench").rglob("*.py"):
        assert not _imports(path) & {"hpccg_tpu", "jax", "jaxlib", "flax"}, path
