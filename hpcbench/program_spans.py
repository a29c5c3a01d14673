"""The port's own spans (``hpccg_tpu_torch.utils.trace``) in a traced run,
read by the ``program_span`` metrics.

The run's set-up and its profiled stretch keep the port's tracing off, as
every untraced run does. The first of these metrics that a traced run reads
sets the system up once more with the port's spans on, the set-up a caller
makes (``run.set_up``: the structure chooser, ``make_cg``, a warm-up solve
of each right-hand side), takes its records (``ctx.setup_spans``), then runs
``trace_solves`` whole solves with no profiler and the spans on
(``ctx.loop_spans``, their iterations ``ctx.loop_iters``), and turns the
spans off. Those solves go through the comparison that decides
``correct``, against the cell's limits; one that fails it fails the run.

Nothing is read, and nothing runs, where the port has no ``utils.trace``
(the metrics are then left out of the line) or off a card: the solver's
metrics are the host's time to issue work to a card, and on the CPU the
kernels' plain versions compute inside the same spans.

Each span is a record with ``name``, ``parent`` (an index into the same
list, -1 at the top), ``start`` and ``end`` in nanoseconds.
"""

from __future__ import annotations

import dataclasses
import json
import sys
from collections import Counter
from pathlib import Path

import torch

DEVICE_TYPE = "cuda"  # where the stretch runs (see above)


def gather(ctx, checks: Path) -> bool:
    """Whether ``ctx`` holds the port's spans, collecting them on the first
    call of a run (``checks``: the folder of the cells' limits files)."""
    if not hasattr(ctx, "loop_spans"):
        ctx.setup_spans = ctx.loop_spans = None
        ctx.loop_iters = 0
        if torch.device(ctx.device).type == DEVICE_TYPE:
            collect(ctx, json.loads((checks / f"{ctx.cell['name']}.json").read_text()))
    return ctx.loop_spans is not None


def collect(ctx, limits: dict) -> None:
    """The set-up and the un-profiled stretch with the port's spans on (see
    the module docstring); sets ``ctx.setup_spans``, ``ctx.loop_spans`` and
    ``ctx.loop_iters``, or nothing where the port has no ``utils.trace``."""
    try:
        from hpccg_tpu_torch.utils import trace
    except ImportError:
        return
    from hpcbench import check, reference, run
    from hpcbench.reference.cg import cg

    again = dataclasses.replace(ctx, spans={}, times=[], iters=[], stretch=None)
    nsamples = int(ctx.traffic["x_samples"])
    solves, samples = [], []
    trace.take()
    trace.enable()
    try:
        runner = run.set_up(again, None)
        setup = trace.take()
        for i in range(int(ctx.traffic["trace_solves"])):
            k = i % len(runner.rhs)
            res = runner.solve(k)
            niters, normr = run.finish(res, ctx.devices)
            solves.append((k, niters, normr, res.trace.to("cpu", torch.float64)))
            if i < nsamples:
                samples.append((i, k, runner.to_input_basis(res.x)))
        loop = trace.take()
    finally:
        trace.disable()
    del runner
    problem, config = ctx.problem, ctx.config
    matvec = reference.matvec(config["reference"], problem, torch.float64, ctx.device)
    refs = [cg(matvec, b.to(torch.float64), problem.x0.to(torch.float64), max_iter=config["max_iter"],
               tolerance=config["tolerance"]) for b in problem.rhs]
    verdict = check.compare(solves, refs, samples, limits)
    if not verdict["correct"]:
        raise RuntimeError(f"the solves with the port's spans on failed the comparison: {verdict['numbers']}")
    ctx.setup_spans, ctx.loop_spans = setup, loop
    ctx.loop_iters = sum(s[1] for s in solves)
    print(f"hpcbench: the port's spans (count, s): set-up {summary(setup)} (harness clock: set-up "
          f"{again.setup_s} s, {again.spans}); {len(solves)} solves {summary(loop)}", file=sys.stderr)


def summary(records) -> dict:
    """{name: [count, total seconds]} of a list of spans."""
    out = {}
    for name, count in Counter(r.name for r in records).items():
        out[name] = [count, total_s(records, name)]
    return out


def total_s(records, name: str) -> float:
    """The summed duration of the spans called ``name``, in seconds."""
    return sum(r.end - r.start for r in records if r.name == name) * 1e-9


def count(records, name: str) -> int:
    return sum(1 for r in records if r.name == name)
