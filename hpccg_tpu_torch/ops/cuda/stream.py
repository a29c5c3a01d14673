"""HBM bandwidth probe kernels (``csrc/stream.cu``): wrappers, plain
versions and launch counters.

- ``copy_plus_one``: y = x + 1 over a contiguous float32 array, the rate of
  a copy (``exp/stream_probe.py:make_pallas_copy``);
- ``write_tiled``: o[i] = seed[i mod |seed|] * 1.00001, the rate of writes
  alone: the seed is small and stays in L2 (``exp/rw_probe.py:write_big``).

``utils/bandwidth.py`` times them. Each wrapper runs its plain version only
for tensors on the CPU; for CUDA tensors it launches the kernel (on the
current stream, without synchronising) or raises, and counts its launches in
``<wrapper>.launches``. The kernels take float32 arrays whose data start on a
16-byte boundary (the kernels' float4 accesses; torch's allocations do), and
a seed of a multiple of 4 elements.
"""

from __future__ import annotations

import torch

from hpccg_tpu_torch.ops.cuda import check_tensors
from hpccg_tpu_torch.ops.cuda.build import check_launch, load_library

SCALE = 1.00001  # exp/rw_probe.py:17


def _check_aligned(**tensors) -> None:
    for name, t in tensors.items():
        if t is not None and t.device.type == "cuda" and t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary (the kernel's float4 accesses)")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def copy_plus_one_plain(x, *, out=None):
    """Plain torch copy probe: x + 1."""
    y = x + 1
    return y if out is None else out.copy_(y)


def copy_plus_one(x, *, out=None):
    """y = x + 1 elementwise, into ``out`` (allocated when None)."""
    check_tensors(x, (torch.float32,), x=(x, None, None), out=(out, tuple(x.shape), None))
    if x.device.type == "cpu":
        return copy_plus_one_plain(x, out=out)
    out = torch.empty_like(x) if out is None else out
    _check_aligned(x=x, out=out)
    with torch.cuda.device(x.device):
        err = load_library().hpccg_stream_copy_f32(x.data_ptr(), out.data_ptr(), x.numel(), _stream(x))
    check_launch(err, "copy probe kernel")
    copy_plus_one.launches += 1
    return out


copy_plus_one.launches = 0


def write_tiled_plain(seed, n: int, *, out=None):
    """Plain torch write probe: the flat seed repeated to n elements, times
    1.00001."""
    flat = seed.reshape(-1)
    o = flat.repeat(-(-n // flat.numel()))[:n] * SCALE
    return o if out is None else out.copy_(o)


def write_tiled(seed, n: int, *, out=None):
    """o[i] = seed.flat[i mod seed.numel()] * 1.00001 for i < n, into the
    flat float32 ``out`` (allocated when None)."""
    check_tensors(seed, (torch.float32,), seed=(seed, None, None), out=(out, (n,), None))
    if seed.numel() % 4 or n < 1:
        raise ValueError(f"the seed must hold a multiple of 4 elements (got {seed.numel()}) and n >= 1 (got {n})")
    if seed.device.type == "cpu":
        return write_tiled_plain(seed, n, out=out)
    out = torch.empty((n,), dtype=seed.dtype, device=seed.device) if out is None else out
    _check_aligned(seed=seed, out=out)
    with torch.cuda.device(seed.device):
        err = load_library().hpccg_stream_write_f32(seed.data_ptr(), seed.numel(), out.data_ptr(), n,
                                                    _stream(seed))
    check_launch(err, "write probe kernel")
    write_tiled.launches += 1
    return out


write_tiled.launches = 0
