"""Build and load the port's hand-written CUDA kernels.

``nvcc`` compiles every ``hpccg_tpu_torch/csrc/*.cu`` for ``sm_90a`` into one
shared library with a plain C interface, ``build/hpccg_tpu_torch/
libhpccg_tpu_torch_kernels.so`` at the root of the checkout, which is loaded
with ctypes. The sources compile in parallel, one ``nvcc -c`` each, and are
linked in one more step (on an H100 host, 8.5-10.0 s against 14.6-18.4 s
for one ``nvcc -shared`` call over all sources). The whole-solve kernel's
grid sync (cooperative_groups) needs no relocatable device code
(``-rdc``). The build happens at first use on a CUDA device, never at
import and never on the CPU; it is redone only when the hash of the sources
and flags changes. The compiler's output (``-Xptxas -v``: registers, shared
memory, spills per kernel) is kept in ``nvcc.log`` beside the library.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

CSRC_DIR = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "hpccg_tpu_torch"
LIB_NAME = "libhpccg_tpu_torch_kernels.so"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong

# (name, argtypes): every pointer and the stream as c_void_p, so ctypes
# never cuts a 64-bit address to a 32-bit int
_SIGNATURES = {
    "hpccg_stencil_num_blocks": [_I] * 4,
    "hpccg_stencil_geometry": [_I] * 4 + [_P],
    "hpccg_stencil_f32": [_P] * 11 + [_I] * 6 + [_P],
    "hpccg_stencil_f64": [_P] * 11 + [_I] * 6 + [_P],
    "hpccg_stencil_bf16": [_P] * 11 + [_I] * 6 + [_P],
    "hpccg_stencil_update_f32": [_P] * 6 + [_I] * 4 + [_P],
    "hpccg_stencil_update_f64": [_P] * 6 + [_I] * 4 + [_P],
    "hpccg_stencil_update_bf16": [_P] * 6 + [_I] * 4 + [_P],
    "hpccg_update_num_blocks": [_LL],
    "hpccg_update_x_r_f32": [_P] * 7 + [_LL, _P],
    "hpccg_update_x_r_f64": [_P] * 7 + [_LL, _P],
    "hpccg_update_x_r_bf16": [_P] * 7 + [_LL, _P],
    "hpccg_finalize_f32": [_P, _I, _P, _P, _P, _I, _P],
    "hpccg_finalize_f64": [_P, _I, _P, _P, _P, _I, _P],
    "hpccg_wholesolve_geometry": [_I] * 6 + [_P],
    "hpccg_wholesolve_f32": [_P] * 8 + [_LL, _P, _I] + [_P] * 3 + [_I] * 5 + [_P],
    "hpccg_wholesolve_f64": [_P] * 8 + [_LL, _P, _I] + [_P] * 3 + [_I] * 5 + [_P],
    "hpccg_wholesolve_bf16": [_P] * 8 + [_LL, _P, _I] + [_P] * 3 + [_I] * 5 + [_P],
    "hpccg_dia_f32": [_P, _P, _I, _P, _P, _LL, _LL, _LL, _P],
    "hpccg_dia_f64": [_P, _P, _I, _P, _P, _LL, _LL, _LL, _P],
    "hpccg_dia_bf16": [_P, _P, _I, _P, _P, _LL, _LL, _LL, _P],
    "hpccg_ell_f32": [_P, _P, _I, _P, _P, _LL, _P],
    "hpccg_ell_f64": [_P, _P, _I, _P, _P, _LL, _P],
    "hpccg_ell_bf16": [_P, _P, _I, _P, _P, _LL, _P],
    "hpccg_ell_scatter_f32": [_P, _P, _I, _P, _P, _P, _P, _LL, _P],
    "hpccg_ell_scatter_f64": [_P, _P, _I, _P, _P, _P, _P, _LL, _P],
    "hpccg_collective_geometry": [_I] * 8 + [_P],
    "hpccg_collective_layout": [_I],
    "hpccg_collective_f32": [_P] * 4 + [_I] * 7 + [_LL, _I, _I, _LL] + [_I] * 3 + [ctypes.c_double, _LL, _I, _P],
    "hpccg_collective_f64": [_P] * 4 + [_I] * 7 + [_LL, _I, _I, _LL] + [_I] * 3 + [ctypes.c_double, _LL, _I, _P],
    "hpccg_collective_bf16": [_P] * 4 + [_I] * 7 + [_LL, _I, _I, _LL] + [_I] * 3 + [ctypes.c_double, _LL, _I, _P],
    "hpccg_peer_enable": [_I, _I],
    "hpccg_zero": [_P, _LL, _P],
    "hpccg_collective_dia_resident_blocks": [_I, _I],
    "hpccg_collective_dia_block_rows": [_I],
    "hpccg_collective_dia_f32": [_P] * 5 + [_I, _I, _LL] + [_I] * 5 + [ctypes.c_double, _LL, _P],
    "hpccg_collective_dia_f64": [_P] * 5 + [_I, _I, _LL] + [_I] * 5 + [ctypes.c_double, _LL, _P],
    "hpccg_stream_copy_f32": [_P, _P, _LL, _P],
    "hpccg_stream_write_f32": [_P, _LL, _P, _LL, _P],
}


def sources() -> list:
    return sorted(CSRC_DIR.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC_DIR.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    candidate = os.path.join(home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError("nvcc not found (looked on PATH and under $CUDA_HOME/bin)")


def build() -> float:
    """Compile the kernel library if its sources changed; returns the
    seconds spent compiling and linking (0.0 when the library was up to
    date)."""
    lib = BUILD_DIR / LIB_NAME
    stamp = BUILD_DIR / (LIB_NAME + ".sha256")
    digest = source_hash()
    if lib.exists() and stamp.exists() and stamp.read_text() == digest:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        objs = [Path(tmpdir) / (src.stem + ".o") for src in sources()]
        cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)] for src, obj in zip(sources(), objs)]
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for c in cmds]
        outs = [p.communicate()[0] for p in procs]
        tmp = Path(tmpdir) / LIB_NAME
        link = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]
        failed = [(c, o) for c, o, p in zip(cmds, outs, procs) if p.returncode != 0]
        log = "".join(" ".join(c) + "\n" + o for c, o in zip(cmds, outs))
        if not failed:
            proc = subprocess.run(link, capture_output=True, text=True)
            log += " ".join(link) + "\n" + proc.stdout + proc.stderr
            if proc.returncode != 0:
                failed = [(link, proc.stdout + proc.stderr)]
        (BUILD_DIR / "nvcc.log").write_text(log)
        if failed:
            cmd, out = failed[0]
            raise RuntimeError(f"nvcc failed: {' '.join(cmd)}\n{out[-4000:]}")
        os.replace(tmp, lib)
    stamp.write_text(digest)
    return time.perf_counter() - t0


@functools.cache
def load_library() -> ctypes.CDLL:
    """The built kernel library, with argtypes set on every entry point."""
    if not torch.cuda.is_available():
        raise RuntimeError("the CUDA kernels need an NVIDIA GPU; torch.cuda is not available")
    build()
    lib = ctypes.CDLL(str(BUILD_DIR / LIB_NAME))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check_launch(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error (its cudaGetLastError)."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
