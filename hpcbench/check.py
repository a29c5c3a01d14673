"""The comparison that decides ``correct``: the program's solves against the
plain reference's, solved once per right-hand side after the window.

Numbers compared, each against the cell's limit (``checks/<cell>.json``):

- ``niters``: the largest gap between a solve's iteration count and the
  reference's (exact: limit 0);
- ``trace_rel``: the largest relative gap of a residual trace entry,
  |t_k - ref_k| / ref_k, over every solve and every k up to niters whose
  reference residual is at least ``head`` (default 0) times the initial
  one (a recurrence that stagnates follows each run's rounding below some
  depth, PERF.md);
- ``normr_rel``: the largest |normr - ref_normr| / ref_normr, the residual
  at the top of the last iteration, which the program reads back apart
  from the trace (held where the reference's is at least ``head`` times
  the initial residual);
- ``x_rel``: max |x - x_ref| / max |x_ref| over the solves whose x was
  kept (a sample drawn from the seed), in the input's basis, so that a
  wrong permutation fails too.

A solve fails where its own niters, trace_rel or normr_rel passes its
limit, or its x does.
"""

from __future__ import annotations

import math

import torch


def trace_gap(trace: torch.Tensor, ref: torch.Tensor, niters: int, head: float) -> float:
    """The largest |t_k - ref_k| / ref_k over k <= niters with ref_k >=
    head * ref_0 (inf where a compared entry is not finite)."""
    k = torch.arange(ref.numel())
    keep = (k <= niters) & (ref >= head * ref[0])
    gap = ((trace[keep] - ref[keep]).abs() / ref[keep]).max()
    value = float(gap)
    return value if math.isfinite(value) else math.inf


def rel_gap(value: float, ref: float) -> float:
    gap = abs(value - ref) / abs(ref) if ref != 0 else (0.0 if value == 0 else math.inf)
    return gap if math.isfinite(gap) else math.inf


def x_gap(x: torch.Tensor, ref: torch.Tensor) -> float:
    value = float((x.to(ref.dtype) - ref).abs().max() / ref.abs().max())
    return value if math.isfinite(value) else math.inf


def compare(solves: list, refs: list, samples: list, limits: dict) -> dict:
    """``solves``: per solve (k, niters, normr, trace as a float64 CPU
    tensor);
    ``refs``: the reference's result per right-hand side; ``samples``:
    (k, x in the input basis). Returns the numbers, their limits, and how
    many solves failed."""
    lim = limits["limits"]
    head = float(limits.get("head", 0.0))
    worst = {"niters": 0.0, "trace_rel": 0.0, "normr_rel": 0.0, "x_rel": 0.0}
    failed = set()
    for i, (k, niters, normr, trace) in enumerate(solves):
        ref = refs[k]
        gaps = {"niters": float(abs(niters - ref["niters"])),
                "trace_rel": trace_gap(trace, ref["trace"].cpu(), min(niters, ref["niters"]), head),
                "normr_rel": rel_gap(normr, ref["normr"]) if ref["normr"] >= head * float(ref["trace"][0]) else 0.0}
        for name, value in gaps.items():
            worst[name] = max(worst[name], value)
            if not value <= lim[name]:
                failed.add(i)
    for i, k, x in samples:
        value = x_gap(x, refs[k]["x"])
        worst["x_rel"] = max(worst["x_rel"], value)
        if not value <= lim["x_rel"]:
            failed.add(i)
    numbers = {name: {"value": value, "limit": lim[name]} for name, value in worst.items()}
    return {"numbers": numbers, "failed": len(failed),
            "correct": not failed and all(n["value"] <= n["limit"] for n in numbers.values())}
