"""Time variants of the copy-probe kernel against torch.add on the card.

    python3 scripts/copy_probe_variants.py [A B C D B1 E F ...]

Each variant is a copy of ``hpccg_tpu_torch/`` under
``build/probe_variants/<name>/`` whose ``csrc/stream.cu`` has another copy
kernel; each runs in its own process (its own build), which prints the
device time of one y = x + 1 launch over 1 GiB of float32 (median of CUDA
events) beside ``torch.add``'s in the same process, and their ratio.
Variants (threads per block, float4 per thread, grid stride, cache hints):

    A   256, 4, grid stride (8 blocks per SM)
    B   256, 4, one block per 1024 float4
    C   A with __ldcs / __stcs
    D   C with 8 float4 per thread
    B1  256, 1, one block per 256 float4
    E   128, 1, one block per 128 float4 (the kernel in csrc/stream.cu)
    F   256, 2, one block per 512 float4

Runs on a CUDA card only.
"""

from __future__ import annotations

import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "probe_variants"
# name -> (threads, float4 per thread, grid stride, streaming hints)
VARIANTS = {"A": (256, 4, 1, 0), "B": (256, 4, 0, 0), "C": (256, 4, 1, 1), "D": (256, 8, 1, 1),
            "B1": (256, 1, 0, 0), "E": (128, 1, 0, 0), "F": (256, 2, 0, 0)}

KERNEL = """constexpr int VNT = {nt}, VUNROLL = {unroll};
__global__ void __launch_bounds__(VNT)
    copy_kernel(const float* __restrict__ x, float* __restrict__ y, int64_t n) {{
  const float4* __restrict__ x4 = reinterpret_cast<const float4*>(x);
  float4* __restrict__ y4 = reinterpret_cast<float4*>(y);
  const int64_t n4 = n / 4;
  const int64_t step = {grid} ? (int64_t)gridDim.x * VNT * VUNROLL : n4;
  for (int64_t base = (int64_t)blockIdx.x * VNT * VUNROLL + threadIdx.x; base < n4; base += step) {{
    float4 v[VUNROLL];
#pragma unroll
    for (int k = 0; k < VUNROLL; ++k) {{
      const int64_t i = base + (int64_t)k * VNT;
      if (i < n4) v[k] = {load};
    }}
#pragma unroll
    for (int k = 0; k < VUNROLL; ++k) {{
      const int64_t i = base + (int64_t)k * VNT;
      if (i < n4) {{
        v[k].x += 1.0f; v[k].y += 1.0f; v[k].z += 1.0f; v[k].w += 1.0f;
        {store};
      }}
    }}
  }}
  if (blockIdx.x == 0) {{
    for (int64_t t = 4 * n4 + threadIdx.x; t < n; t += VNT) y[t] = x[t] + 1.0f;
  }}
}}

int copy_blocks(int64_t n4) {{
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int64_t want = (n4 + (int64_t)VNT * VUNROLL - 1) / ((int64_t)VNT * VUNROLL);
  const int64_t cap = {grid} ? (int64_t)sms * 8 : want;
  return (int)(want < 1 ? 1 : (want < cap ? want : cap));
}}

"""

LAUNCH = "copy_kernel<<<copy_blocks(n / 4), VNT, 0, (cudaStream_t)stream>>>(x, y, n);"

TIMER = """
import statistics, sys, torch
from hpccg_tpu_torch.ops.cuda import stream
n = 1 << 28
x = torch.randn((n,), device="cuda"); y = torch.empty_like(x)
stream.copy_plus_one(x, out=y); torch.cuda.synchronize()
assert torch.equal(y, x + 1)
def ms(fn, reps=15):
    out = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record(); fn(); b.record(); b.synchronize(); out.append(a.elapsed_time(b))
    return statistics.median(out[3:])
k = ms(lambda: stream.copy_plus_one(x, out=y)); lib = ms(lambda: torch.add(x, 1, out=y))
print(f"{sys.argv[1]}: kernel {k*1e3:.1f} us ({8*n/k/1e6:.0f} GB/s), torch.add {lib*1e3:.1f} us "
      f"({8*n/lib/1e6:.0f} GB/s), ratio {k/lib:.4f}", flush=True)
"""


def variant_source(name: str) -> str:
    """csrc/stream.cu with the copy kernel and its launch of ``name``."""
    src = (ROOT / "hpccg_tpu_torch/csrc/stream.cu").read_text()
    nt, unroll, grid, hints = VARIANTS[name]
    kernel = KERNEL.format(nt=nt, unroll=unroll, grid=grid,
                           load="__ldcs(x4 + i)" if hints else "x4[i]",
                           store="__stcs(y4 + i, v[k])" if hints else "y4[i] = v[k]")
    start = src.index("__global__ void __launch_bounds__(COPY_NT)")
    end = src.index("// o[i] = seed[i mod m]")
    launch = src.index("  const long long blocks = (n / 4 + COPY_NT - 1) / COPY_NT;")
    launch_end = src.index("  return (int)cudaGetLastError();", launch)
    return src[:start] + kernel + src[end:launch] + "  " + LAUNCH + "\n" + src[launch_end:]


def main(names) -> int:
    for name in names:
        dst = OUT / name
        shutil.rmtree(dst, ignore_errors=True)
        shutil.copytree(ROOT / "hpccg_tpu_torch", dst / "hpccg_tpu_torch",
                        ignore=shutil.ignore_patterns("__pycache__"))
        (dst / "hpccg_tpu_torch/csrc/stream.cu").write_text(variant_source(name))
    for name in names:
        proc = subprocess.run([sys.executable, "-c", TIMER, name], cwd=OUT / name, capture_output=True,
                              text=True, timeout=600)
        print(proc.stdout.strip() or f"{name}: failed\n{proc.stderr[-2000:]}", flush=True)
        if proc.returncode != 0:
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:] or ["A", "B", "C", "D", "B1", "E", "F", "A", "E"]))
