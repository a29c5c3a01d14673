"""The traced stretch: whole solves under ``torch.profiler``, reduced to the
device's busy intervals, kernel counts and the breakdown.

Each solve runs inside a ``hpcbench.solve`` span and ends with its result
on the host, so the device events of solve i lie inside its span. The
profiler drops device events now and then (PERF.md): a stretch whose
solves did not all launch the same number of kernels is taken again, up to
three times, and then the run fails.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses

import torch

from hpcbench.metrics import union

SOLVE_SPAN = "hpcbench.solve"
STRETCH_SPAN = "hpcbench.stretch"
ATTEMPTS = 3
NAME_CHARS = 160


@dataclasses.dataclass
class Stretch:
    """What one traced stretch read, in seconds on the profiler's clock."""

    outputs: list  # what each solve returned
    window: tuple  # (start, end) of the stretch span
    busy: list  # (start, end) of every device operation
    kernels: int  # kernel launches in the stretch
    per_solve: list  # kernel launches of each solve
    device_ops: list  # [name, seconds] by total device time
    idle_gaps: list  # [name, seconds]: device idle time by what the host was doing

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    @property
    def busy_s(self) -> float:
        lo, hi = self.window
        return sum(max(0.0, min(e, hi) - max(s, lo)) for s, e in union(self.busy))


def _is_kernel(name: str) -> bool:
    return not name.startswith(("Memcpy", "Memset", "cudaMemcpy", "cudaMemset"))


def _span(ev) -> tuple:
    return ev.time_range.start * 1e-6, ev.time_range.end * 1e-6


def _top(counter: dict, k: int = 10) -> list:
    return [[name, seconds] for name, seconds in sorted(counter.items(), key=lambda kv: -kv[1])[:k]]


def _idle_gaps(host, busy, window) -> list:
    """Device idle time within ``window`` by the innermost host event open
    at each gap's middle (the host events are one thread's, so they nest)."""
    gaps, t = [], window[0]
    for s, e in union(busy):
        if s > t:
            gaps.append((t, min(s, window[1])))
        t = max(t, e)
    if t < window[1]:
        gaps.append((t, window[1]))
    host = sorted(host)
    starts = [h[0] for h in host]
    by_name = collections.Counter()
    stack, i = [], 0
    for lo, hi in sorted(gaps):
        mid = 0.5 * (lo + hi)
        for h in host[i:bisect.bisect_right(starts, mid)]:
            while stack and stack[-1][1] < h[0]:
                stack.pop()
            stack.append(h)
            i += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        by_name[stack[-1][2] if stack else "(no host span)"] += hi - lo
    return _top(by_name)


def _annotation(ev) -> bool:
    """A span of the harness, which the profiler repeats on the device's
    timeline: no device operation."""
    return getattr(ev, "is_user_annotation", False) or ev.name.startswith("hpcbench.")


def reduce_profile(events, nsolves: int):
    """(window, busy, per-solve kernel counts, device_ops, idle_gaps) of a
    profile's events."""
    cuda = torch.autograd.DeviceType.CUDA
    device = [ev for ev in events if ev.device_type == cuda and not _annotation(ev)]
    host = [ev for ev in events if ev.device_type != cuda]
    stretch = [ev for ev in host if ev.name == STRETCH_SPAN]
    if len(stretch) != 1:
        raise RuntimeError(f"the profile holds {len(stretch)} {STRETCH_SPAN} spans")
    window = _span(stretch[0])
    thread = stretch[0].thread
    solves = sorted(_span(ev) for ev in host if ev.name == SOLVE_SPAN)
    if len(solves) != nsolves:
        raise RuntimeError(f"the profile holds {len(solves)} of {nsolves} {SOLVE_SPAN} spans")
    per_solve = [0] * nsolves
    busy, ops = [], collections.Counter()
    starts = [s for s, _ in solves]
    for ev in device:
        s, e = _span(ev)
        busy.append((s, e))
        ops[ev.name[:NAME_CHARS]] += e - s
        if _is_kernel(ev.name):
            i = bisect.bisect_right(starts, s) - 1
            if i < 0 or s > solves[i][1]:
                per_solve.append(-1)  # a kernel outside every solve: not a sound stretch
            else:
                per_solve[i] += 1
    host_spans = [(*_span(ev), ev.name[:NAME_CHARS]) for ev in host if ev.thread == thread]
    return window, busy, per_solve, _top(ops), _idle_gaps(host_spans, busy, window)


def profile_stretch(run_one, nsolves: int, device) -> Stretch:
    """Run ``run_one(i)`` for i < nsolves under torch.profiler and reduce
    the trace."""
    from torch.profiler import ProfilerActivity, profile, record_function

    on_card = torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    for _ in range(ATTEMPTS):
        outputs = []
        with profile(activities=activities) as prof:
            with record_function(STRETCH_SPAN):
                for i in range(nsolves):
                    with record_function(SOLVE_SPAN):
                        outputs.append(run_one(i))
        window, busy, per_solve, ops, gaps = reduce_profile(prof.events(), nsolves)
        sound = len(per_solve) == nsolves and len(set(per_solve)) == 1
        if not on_card or (sound and per_solve[0] > 0):
            return Stretch(outputs, window, busy, sum(per_solve), per_solve, ops, gaps)
    raise RuntimeError(f"torch.profiler gave solves with unequal kernel counts {ATTEMPTS} times "
                       f"(last: {per_solve})")
