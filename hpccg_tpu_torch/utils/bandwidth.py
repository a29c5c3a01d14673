"""Memory bandwidth of the device, measured by the probe kernels
(``ops/cuda/stream.py``): the counterpart of ``exp/stream_probe.py`` and
``exp/rw_probe.py``.

- copy rate = 2 * bytes / t: y = x + 1 reads x and writes y;
- write rate = bytes / t: o = tile(seed) * 1.00001 writes o, and the seed
  (the JAX probe's (512, 128) float32 block, 256 KB) stays in L2.

Each is slope-timed (``utils/timing.time_loop_slope``: CUDA events on the
card, interleaved pairs of a short and a long run of launches, median
slope). On the card each array is at least 1 GiB, 20 times the H100's 50 MB
L2, so neither rate is the L2's; the JAX probes' arrays (69.2 MB copy,
134 MB write) are about L2-sized there. On the CPU the plain versions run
at the size the caller passes, and the rates are the host memory's.
"""

from __future__ import annotations

import dataclasses

import torch

from hpccg_tpu_torch.ops.cuda.stream import copy_plus_one, write_tiled
from hpccg_tpu_torch.utils.timing import time_loop_slope

MIN_CARD_BYTES = 1 << 30  # per array on the card
SEED_SHAPE = (512, 128)  # (RB, LANE), exp/rw_probe.py:13
SHORT, LONG = 4, 20  # launches per leg: each launch streams >= 1 GiB on the card


@dataclasses.dataclass(frozen=True)
class Bandwidth:
    """Measured rates in GB/s (1e9 bytes per second), the bytes of each
    array and the device they were measured on."""

    copy_gbps: float
    write_gbps: float
    nbytes: int
    device: str


def _elements(nbytes: int) -> int:
    """float32 elements in ``nbytes``, a whole number of seed tiles."""
    tile = SEED_SHAPE[0] * SEED_SHAPE[1]
    n = (nbytes // 4) // tile * tile
    if n < tile:
        raise ValueError(f"{nbytes} bytes hold less than one {SEED_SHAPE} float32 seed tile")
    return n


def measure(device="cuda", nbytes=None, reps: int = 3) -> Bandwidth:
    """The copy and write rates of ``device``'s memory. On CUDA ``nbytes``
    (bytes per array) defaults to 1 GiB and may not be less; on the CPU it
    must be given."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("the bandwidth probe needs an NVIDIA GPU; torch.cuda is not available")
        nbytes = MIN_CARD_BYTES if nbytes is None else nbytes
        if nbytes < MIN_CARD_BYTES:
            raise ValueError(f"{nbytes} bytes per array would measure the L2; the card needs >= {MIN_CARD_BYTES}")
    elif nbytes is None:
        raise ValueError("on the CPU the caller gives the probe's size (nbytes)")
    n = _elements(nbytes)
    bufs = [torch.zeros((n,), dtype=torch.float32, device=device), torch.empty((n,), dtype=torch.float32,
                                                                               device=device)]
    seed = torch.ones(SEED_SHAPE, dtype=torch.float32, device=device)

    def copies(k):
        for i in range(k):
            copy_plus_one(bufs[i % 2], out=bufs[(i + 1) % 2])

    def writes(k):
        for _ in range(k):
            write_tiled(seed, n, out=bufs[0])

    t_copy = time_loop_slope(copies, device=device, short=SHORT, long=LONG, reps=reps)
    t_write = time_loop_slope(writes, device=device, short=SHORT, long=LONG, reps=reps)
    nb = 4 * n
    return Bandwidth(copy_gbps=2 * nb / t_copy / 1e9 if t_copy > 0 else float("inf"),
                     write_gbps=nb / t_write / 1e9 if t_write > 0 else float("inf"), nbytes=nb,
                     device=str(device))
