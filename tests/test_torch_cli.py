"""The port's CLI against hpccg_tpu.cli (stencil mode, on the CPU)."""

import io
import json
from contextlib import redirect_stdout

import pytest

torch = pytest.importorskip("torch")

from hpccg_tpu.cli import main as jax_main  # noqa: E402
from hpccg_tpu_torch.cli import main  # noqa: E402


def _run(fn, args):
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = fn(args)
    return rc, buf.getvalue()


def _report(out):
    return json.loads(out[out.index("{"):])  # after the residual lines


def _keys(obj, prefix=""):
    """Every key path of the report, without the parenthesised notes, whose
    text names each package's own backends and devices."""
    out = set()
    for k, v in obj.items():
        if "(" in k:
            continue
        out.add(prefix + k)
        if isinstance(v, dict):
            out |= _keys(v, prefix + k + "/")
    return out


def test_json_report_matches_jax_cli():
    args = ["8", "8", "8", "--json", "--skip-kernel-bench"]
    rc, out = _run(main, args + ["--device", "cpu"])
    jrc, jout = _run(jax_main, args)
    assert rc == jrc == 0
    rep, jrep = _report(out), _report(jout)
    assert _keys(rep) == _keys(jrep)
    assert rep["Number of iterations"] == jrep["Number of iterations"] == 149
    assert rep["FLOPS Summary"] == jrep["FLOPS Summary"]
    assert rep["Parallelism"]["Platform"] == "cpu"


def test_yaml_report_golden_lines():
    rc, out = _run(main, ["10", "10", "10", "--device", "cpu", "--skip-kernel-bench", "--check"])
    assert rc == 0
    assert "Initial Residual = 258.24" in out
    assert "Iteration = 15   Residual = 2.15402e-06" in out
    assert "Number of iterations: 149" in out
    assert "  Total   : 9.536e+06" in out  # FLOP model, main.cpp:224-227
    line = [ln for ln in out.splitlines() if ln.startswith("Difference between computed and exact =")][0]
    assert float(line.split("=")[-1]) < 1e-12


@pytest.mark.parametrize("backend", ["stencil", "pallas", "pallas_fused"])
def test_backends_and_kernel_bench(backend):
    rc, out = _run(main, ["6", "5", "4", "--device", "cpu", "--dtype", "float32", "--backend", backend,
                          "--quiet", "--json", "--max-iter", "20", "--validate"])
    assert rc == 0
    ts = _report(out)["Time Summary"]
    assert ts["SPARSEMV"] >= 0 and ts["WAXPBY  "] >= 0  # slope-timed, not skipped


@pytest.mark.parametrize("extra", [
    ["--backend", "ell"], ["--mesh", "2x4"], ["--mesh", "4x1"], ["--backend", "ell", "--mesh", "2"],
    ["--stream-load", "--mesh", "2"], ["--backend", "dia"], ["--dump-matlab", "mat", "--mesh", "2"],
    ["--stream-load"], ["--dump-matlab", "mat"],
])
def test_not_yet_ported_flags_exit_2(extra, capsys):
    """What waits for a later slice exits 2 and says so (--mesh N, --method,
    --rr-every, --refine and --backend collective are ported:
    tests/test_torch_distributed.py, tests/test_torch_methods.py)."""
    assert main(["4", "4", "4", "--device", "cpu"] + extra) == 2
    assert "not yet ported" in capsys.readouterr().err


@pytest.mark.parametrize("extra", [["--backend", "megakernel"], ["--backend", "streamkernel"],
                                   ["--dtype", "bfloat16"]])
def test_whole_solve_backends_and_bf16(extra):
    """The whole-solve backends report DDOT and WAXPBY as fused into the
    solve (empty, with a note); bf16 leaves SPARSEMV empty (K1 has no bf16
    instance yet)."""
    rc, out = _run(main, ["6", "5", "4", "--device", "cpu", "--quiet", "--json", "--max-iter", "20",
                          "--validate"] + extra)
    assert rc == 0
    rep = _report(out)
    assert rep["Number of iterations"] == 19
    ts = rep["Time Summary"]
    note = next(k for k in ts if k.startswith("("))
    whole = "--backend" in extra
    assert (ts["DDOT    "] != ts["DDOT    "]) == whole and (ts["WAXPBY  "] != ts["WAXPBY  "]) == whole
    assert ("fused into the whole-solve kernel" in note) == whole
    bf16 = "bfloat16" in extra
    assert (ts["SPARSEMV"] != ts["SPARSEMV"]) == bf16 and ("no bfloat16 instance" in note) == bf16
    assert rep["Dimensions"]["dtype"] == ("bfloat16" if bf16 else "float64")


def test_pallas_dd_refuses_float32(capsys):
    assert main(["4", "4", "4", "--device", "cpu", "--dtype", "float32", "--backend", "pallas_dd"]) == 2
    assert "pallas_dd" in capsys.readouterr().err


def test_file_mode_exits_2(capsys):
    """File mode is ported; a file it cannot read exits 2 and says why."""
    assert main(["matrix.dat", "--device", "cpu"]) == 2
    assert "cannot read matrix.dat" in capsys.readouterr().err


def test_cuda_device_without_gpu_says_pass_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        main(["4", "4", "4"])
