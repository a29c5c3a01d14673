"""The traced stretch: whole solves under ``torch.profiler``, reduced to
each card's busy intervals, kernel counts and the breakdown.

Each solve runs inside a ``hpcbench.solve`` span and ends with its result
on the host and every card of the cell idle. A device operation counts for
the solve whose span holds its launch: the host's runtime call with the
same correlation id, on the host's clock, or where the trace has none, the
operation's own start. (Each card's clock, converted to the host's, can
put a solve's kernels past the end of its span or into its neighbour's:
seen on H100s, the last five kernels of the last explicit 128^3 solve on
one card, and up to 11 kernels a solve moved between solves on four
cards.) The profiler can lose the first kernels it would record (seen on
an H100: the first kernel of the first solve, in three of four stretches of
one process), so each card runs ``PREROLL`` spin kernels under the
profiler before the stretch, and operations launched before the stretch
are left out. A stretch whose solves did not all launch the same number of
kernels (summed over the cards), or with a kernel launched in the stretch
before the first solve, is taken again, up to three times, and then the
run fails.

Device events are grouped by card (``device_index``). ``busy_s`` is the
mean over the cell's cards of each card's busy time in the stretch (a card
that ran nothing counts with 0); the breakdown's ``device_ops`` and
``idle_gaps`` are summed over the cards, each card's idle gaps named by the
host span open at the gap's middle. On one card each is the one card's.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses

import torch

from hpcbench.metrics import covered, idle_share, union

SOLVE_SPAN = "hpcbench.solve"
STRETCH_SPAN = "hpcbench.stretch"
ATTEMPTS = 3
PREROLL = 8  # kernels each card runs under the profiler before the stretch
NAME_CHARS = 160


@dataclasses.dataclass
class Stretch:
    """What one traced stretch read, in seconds on the profiler's clock."""

    outputs: list  # what each solve returned
    window: tuple  # (start, end) of the stretch span
    cards: tuple  # the cell's cards, by device index
    busy: dict  # card -> (start, end) of each of its device operations
    kernels: int  # kernel launches in the stretch, every card's
    per_solve: list  # kernel launches of each solve, every card's
    device_ops: list  # [name, seconds] by total device time, summed over cards
    idle_gaps: list  # [name, seconds]: each card's idle time by what the host was doing, summed

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    @property
    def cards_ran(self) -> list:
        """The cards on which a device operation ran."""
        return [c for c, ivs in self.busy.items() if ivs]

    def busy_per_card(self) -> list:
        return [covered(self.busy.get(c, []), *self.window) for c in self.cards]

    def idle_shares(self) -> list:
        return [idle_share(self.busy.get(c, []), *self.window) for c in self.cards]

    @property
    def busy_s(self) -> float:
        """The mean over the cell's cards of each card's busy time."""
        per_card = self.busy_per_card()
        return sum(per_card) / len(per_card) if per_card else 0.0


def _is_kernel(name: str) -> bool:
    return not name.startswith(("Memcpy", "Memset", "cudaMemcpy", "cudaMemset"))


def _span(ev) -> tuple:
    return ev.time_range.start * 1e-6, ev.time_range.end * 1e-6


def _top(counter: dict, k: int = 10) -> list:
    return [[name, seconds] for name, seconds in sorted(counter.items(), key=lambda kv: -kv[1])[:k]]


def _idle_gaps(host, busy, window) -> collections.Counter:
    """One card's idle time within ``window`` by the innermost host event
    open at each gap's middle (the host events are one thread's, so they
    nest)."""
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
    return by_name


def _annotation(ev) -> bool:
    """A span of the harness, which the profiler repeats on the device's
    timeline: no device operation."""
    return getattr(ev, "is_user_annotation", False) or ev.name.startswith("hpcbench.")


def reduce_profile(events, nsolves: int, cards: list):
    """(window, busy by card, per-solve kernel counts, device_ops,
    idle_gaps) of a profile's events. ``cards``: the cell's cards by index;
    ``busy`` has an entry for each of them and for any other card that ran
    something."""
    cuda = torch.autograd.DeviceType.CUDA
    host = [ev for ev in events if ev.device_type != cuda]
    stretch = [ev for ev in host if ev.name == STRETCH_SPAN]
    if len(stretch) != 1:
        raise RuntimeError(f"the profile holds {len(stretch)} {STRETCH_SPAN} spans")
    window = _span(stretch[0])
    launched = {ev.id: _span(ev)[0] for ev in host if ev.name.startswith("cu")}  # runtime calls
    device = [(launched.get(ev.id, _span(ev)[0]), ev) for ev in events
              if ev.device_type == cuda and not _annotation(ev)]
    thread = stretch[0].thread
    solves = sorted(_span(ev) for ev in host if ev.name == SOLVE_SPAN)
    if len(solves) != nsolves:
        raise RuntimeError(f"the profile holds {len(solves)} of {nsolves} {SOLVE_SPAN} spans")
    per_solve = [0] * nsolves
    busy, ops = {c: [] for c in cards}, collections.Counter()
    starts = [s for s, _ in solves]
    for t, ev in device:
        if t < window[0]:
            continue  # launched before the stretch: the pre-roll
        s, e = _span(ev)
        busy.setdefault(ev.device_index, []).append((s, e))
        ops[ev.name[:NAME_CHARS]] += e - s
        if _is_kernel(ev.name):
            i = bisect.bisect_right(starts, t) - 1
            if i < 0:
                per_solve.append(-1)  # a kernel launched in the stretch before the first solve: not sound
            else:
                per_solve[i] += 1
    host_spans = [(*_span(ev), ev.name[:NAME_CHARS]) for ev in host if ev.thread == thread]
    gaps = collections.Counter()
    for c in cards:
        gaps.update(_idle_gaps(host_spans, busy[c], window))
    return window, busy, per_solve, _top(ops), _top(gaps)


def profile_stretch(run_one, nsolves: int, cards: list) -> Stretch:
    """Run ``run_one(i)`` for i < nsolves under torch.profiler and reduce
    the trace (``cards``: the cell's CUDA cards by index, none off a
    card)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    on_card = bool(cards)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    for _ in range(ATTEMPTS):
        outputs = []
        with profile(activities=activities) as prof:
            for c in cards:  # spin kernels: they allocate nothing, so no card looks used for them
                with torch.cuda.device(c):
                    for _ in range(PREROLL):
                        torch.cuda._sleep(1000)
                torch.cuda.synchronize(c)
            with record_function(STRETCH_SPAN):
                for i in range(nsolves):
                    with record_function(SOLVE_SPAN):
                        outputs.append(run_one(i))
        window, busy, per_solve, ops, gaps = reduce_profile(prof.events(), nsolves, cards)
        sound = len(per_solve) == nsolves and len(set(per_solve)) == 1
        if not on_card or (sound and per_solve[0] > 0):
            return Stretch(outputs, window, tuple(cards), busy, sum(per_solve), per_solve, ops, gaps)
    raise RuntimeError(f"torch.profiler gave solves with unequal kernel counts {ATTEMPTS} times "
                       f"(last: {per_solve})")
