"""Device timing (ref mytimer.cpp; ``hpccg_tpu.utils.timing``).

On CUDA, times come from CUDA events recorded on the current stream: the
host returns before the card finishes, so a host clock without a fence
would time the enqueue. On the CPU the host clock is the device clock.
"""

from __future__ import annotations

import statistics
import time
from typing import Callable

import torch


def fence(device=None) -> None:
    """Wait for all work queued on a CUDA device (no-op on the CPU)."""
    if device is None or torch.device(device).type == "cuda":
        if torch.cuda.is_available():
            torch.cuda.synchronize(device)


def elapsed(fn: Callable[[], object], device) -> float:
    """Seconds that ``fn()``'s work takes on ``device`` (CUDA events on a
    GPU, the host clock after a fence on the CPU)."""
    if torch.device(device).type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def time_loop_slope(
    run: Callable[[int], object], *, device, short: int = 65, long: int = 1025, reps: int = 3
) -> float:
    """Seconds per iteration of ``run(k)``, which runs k iterations.

    The (short, long) pair is timed interleaved and the median of the
    per-pair slopes (t_long - t_short) / (long - short) is returned: the
    fixed cost of a call (set-up, launch latency, the first fence) cancels,
    and a pair shares one clock epoch of the card."""
    run(short)
    run(long)
    fence(device)
    slopes = []
    for _ in range(max(reps, 3)):
        t_short = elapsed(lambda: run(short), device)
        t_long = elapsed(lambda: run(long), device)
        slopes.append((t_long - t_short) / (long - short))
    # 0.0 = "below timer resolution", as the reference's golden run reports
    return max(statistics.median(slopes), 0.0)
