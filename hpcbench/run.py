"""The benchmark of hpccg_tpu_torch: one cell, one run.

    python3 -m hpcbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cell's NVIDIA GPUs. The
cell (an entry of ``BENCHMARK.json``'s ``workloads``) names a configuration
and a traffic mix; the harness makes the inputs from the seed, sets the
system up (timed: ``setup_s``), and then one caller runs a closed loop of
whole solves for ``--seconds`` (``--trace 0``) or a short stretch of them
under torch.profiler (``--trace 1``). After the window the plain reference
solves each right-hand side once and the comparison decides ``correct``.

A cell of ``chips`` cards runs on ``cuda:0`` ... ``cuda:{chips-1}`` (on the
CPU, ``chips`` ranks on ``"cpu"``): the builder is told those devices, the
inputs and the reference stay on the first, every fence waits for all of
them, and ``device.count`` is the number of cards the run was seen to use.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, then ``notes`` and, last, ``checks`` (each number compared
with its limit; they are also the last lines of standard error). Exit
codes: 2 without the GPUs the cell asks for, 3 when a module of JAX or of
the JAX package was loaded, 1 when the run used fewer cards than the cell's
``chips`` or on any other failure; no result then.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import random
import subprocess
import sys
import time
from contextlib import contextmanager
from typing import Callable, Optional, Sequence

import torch

from hpcbench import check, inputs, reference, systems
from hpcbench.reference.cg import cg
from hpcbench.registry import Bench
from hpcbench.trace import profile_stretch

# top-level module names that may not be loaded in a run: JAX and the JAX
# package (compared whole: hpccg_tpu_torch is the program)
FORBIDDEN = ("jax", "jaxlib", "flax", "hpccg_tpu")


class Spans:
    """Seconds of named set-up steps, on the host clock."""

    def __init__(self):
        self.seconds = {}

    @contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.seconds[name] = self.seconds.get(name, 0.0) + time.perf_counter() - t0


@dataclasses.dataclass
class Context:
    """What a run measured; the metric readers read it. ``device`` is the
    first of the cell's ``devices``, where the inputs and the reference
    live."""

    cell: dict
    config: dict
    traffic: dict
    problem: inputs.Problem
    device: str
    device_kind: str
    setup_s: float = 0.0
    build_s: float = 0.0
    spans: dict = dataclasses.field(default_factory=dict)
    times: list = dataclasses.field(default_factory=list)  # seconds of each solve in the window
    iters: list = dataclasses.field(default_factory=list)  # iterations of each solve in the window
    window_s: Optional[float] = None  # window start to the last completion
    stretch: object = None  # trace.Stretch of a traced run
    stretch_iters: int = 0
    devices: tuple = ()  # the cell's devices (default: ``device`` alone)

    def __post_init__(self):
        self.devices = tuple(torch.device(d) for d in (self.devices or (self.device,)))

    @property
    def explicit(self) -> bool:
        return self.config["form"] == "arrays"

    @property
    def chips(self) -> int:
        return len(self.devices)


def cell_devices(kind: str, chips: int) -> tuple:
    """The devices of a cell of ``chips`` cards: ``cuda:0`` ...
    ``cuda:{chips-1}``, or on the CPU ``chips`` ranks on ``cpu``."""
    if torch.device(kind).type == "cuda":
        return tuple(torch.device("cuda", i) for i in range(chips))
    return (torch.device(kind),) * chips


def card_indexes(devices: Sequence) -> list:
    """The distinct CUDA cards among ``devices``, by index, in order."""
    out = []
    for d in map(torch.device, devices):
        if d.type == "cuda" and d.index not in out:
            out.append(d.index)
    return out


def fence(devices: Sequence) -> None:
    """Wait for the work queued on every card of the cell."""
    for i in card_indexes(devices):
        torch.cuda.synchronize(i)


def finish(res, devices: Sequence) -> tuple:
    """Wait until the result is on the host and every card has finished;
    returns (niters, normr)."""
    niters, normr = int(res.niters), float(res.normr)
    fence(devices)
    return niters, normr


class Cards:
    """The cell's cards' memory: their peaks reset before set-up, and the
    allocation each held then, so that a card whose allocation rose during
    the run counts as used."""

    def __init__(self, devices: Sequence):
        self.cards = card_indexes(devices)
        self.base = {}

    def reset(self) -> None:
        for i in self.cards:
            torch.cuda.synchronize(i)
            torch.cuda.reset_peak_memory_stats(i)
            self.base[i] = torch.cuda.memory_allocated(i)

    def peaks(self) -> dict:
        return {i: torch.cuda.max_memory_allocated(i) for i in self.cards}


class UnusedCards(RuntimeError):
    """The run used fewer cards than the cell's ``chips``."""


def used_cards(cards: Sequence, base: dict, peaks: dict, ran: Sequence = ()) -> list:
    """The cards that a run used: those whose allocated memory rose above
    what they held when the peaks were reset, and those that ran kernels in
    the traced stretch (``ran``)."""
    return [i for i in cards if peaks[i] > base.get(i, 0) or i in ran]


class Reservoir:
    """A uniform sample of ``size`` items from a stream, drawn from the
    seed (algorithm R)."""

    def __init__(self, size: int, seed: int):
        self.size, self.rng, self.items, self.seen = size, random.Random(seed), [], 0

    def offer(self, item) -> None:
        if len(self.items) < self.size:
            self.items.append(item)
        else:
            j = self.rng.randrange(self.seen + 1)
            if j < self.size:
                self.items[j] = item
        self.seen += 1


def set_up(ctx: Context, system: Optional[Callable]):
    """The program's set-up, timed as ``setup_s``: importing the port,
    building or loading its kernel library, the system's own set-up and a
    warm-up solve of each right-hand side. The warm-up holds as many
    results at once as the window's sample of x does, so that the window
    finds every block it allocates in the caching allocator."""
    spans = Spans()
    t0 = time.perf_counter()
    import hpccg_tpu_torch  # noqa: F401  (the port: its import is set-up)

    if torch.device(ctx.device).type == "cuda":
        from hpccg_tpu_torch.ops.cuda.build import build, load_library

        ctx.build_s = build()
        load_library()
    if system is None:
        runner = systems.setup(ctx.config["system"], ctx.config, ctx.problem, ctx.devices, spans)
    else:
        runner = system(ctx.config, ctx.problem, ctx.devices, spans)
    nrhs = len(runner.rhs)
    held = []  # as many results alive at once as the window's sample holds
    for i in range(max(nrhs, int(ctx.traffic["x_samples"]) + 1)):
        res = runner.solve(i % nrhs)
        finish(res, ctx.devices)
        held.append(res)
    del held, res
    ctx.setup_s = time.perf_counter() - t0
    ctx.spans = spans.seconds
    return runner


def window(ctx: Context, runner, seconds: float, sample: Reservoir) -> list:
    """The closed loop of one caller: whole solves, right-hand sides in
    turn, each timed from the call until its result is on the host."""
    solves, nrhs = [], len(runner.rhs)
    t_start = time.perf_counter()
    deadline = t_start + seconds
    t1 = t_start
    i = 0
    while time.perf_counter() < deadline:
        k = i % nrhs
        t0 = time.perf_counter()
        res = runner.solve(k)
        niters, normr = finish(res, ctx.devices)
        t1 = time.perf_counter()
        ctx.times.append(t1 - t0)
        ctx.iters.append(niters)
        solves.append((k, niters, normr, res.trace))
        sample.offer((i, k, res.x))
        i += 1
    ctx.window_s = t1 - t_start
    return solves


def traced(ctx: Context, runner, nsolves: int, sample: Reservoir) -> list:
    """A stretch of whole solves under torch.profiler."""
    nrhs = len(runner.rhs)

    def one(i):
        k = i % nrhs
        res = runner.solve(k)
        niters, normr = finish(res, ctx.devices)
        sample.offer((i, k, res.x))
        return k, niters, normr, res.trace

    ctx.stretch = profile_stretch(one, nsolves, card_indexes(ctx.devices))
    solves, ctx.stretch.outputs = ctx.stretch.outputs, None
    ctx.stretch_iters = sum(s[1] for s in solves)
    return solves


def device_info(ctx: Context, cards: Cards) -> tuple:
    """The line's ``device`` and the cards the run used. ``count`` is
    measured (``used_cards``), never copied from ``chips``; off a card it is
    1, the host. ``memory_peak_bytes`` is the fullest card's peak."""
    on_card = torch.device(ctx.device).type == "cuda"
    peaks = cards.peaks()
    ran = ctx.stretch.cards_ran if ctx.stretch is not None else ()
    used = used_cards(cards.cards, cards.base, peaks, ran)
    per_card = [peaks[i] for i in cards.cards]
    info = {"platform": "gpu" if on_card else "cpu", "kind": ctx.device_kind,
            "count": len(used) if cards.cards else 1, "memory_peak_bytes": max(per_card, default=0),
            "memory_peak_bytes_per_card": per_card}
    if ctx.stretch is not None:
        info["busy_s"] = ctx.stretch.busy_s
        info["window_s"] = ctx.stretch.window_s
    return info, used


def power_limit() -> Optional[str]:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else None


def run_cell(bench: Bench, cell_name: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             system: Optional[Callable] = None, all_cards: bool = True) -> dict:
    """One run of a cell; returns the result line as a dict. ``device``
    is the kind of device (``cuda`` or ``cpu``), from which the cell's
    devices follow (``cell_devices``). ``system``, a ``setup(config,
    problem, devices, spans) -> Runner``, replaces the configuration's
    builder (the control and the tests). Raises ``UnusedCards`` where the
    run used fewer cards than the cell's ``chips``, unless ``all_cards`` is
    false (the control, which runs on the first card alone)."""
    cell = bench.cell(cell_name)
    config = bench.config(cell["config"])
    traffic = bench.traffic(cell["traffic"])
    limits = bench.limits(cell_name)
    if int(traffic.get("clients", 1)) != 1 or traffic.get("loop", "closed") != "closed":
        raise ValueError("the generator drives one caller in a closed loop")
    devices = cell_devices(device, int(cell["chips"]))
    problem = inputs.make(config, traffic, seed, devices[0])
    on_card = devices[0].type == "cuda"
    cards = Cards(devices)
    cards.reset()
    ctx = Context(cell, config, traffic, problem, devices[0],
                  torch.cuda.get_device_name(devices[0]) if on_card else "cpu", devices=devices)
    runner = set_up(ctx, system)
    sample = Reservoir(int(traffic["x_samples"]), seed)
    if trace:
        solves = traced(ctx, runner, int(traffic["trace_solves"]), sample)
    else:
        solves = window(ctx, runner, seconds, sample)
    dev_info, used = device_info(ctx, cards)
    if all_cards and len(used) < len(cards.cards):
        unused = ", ".join(f"cuda:{i}" for i in cards.cards if i not in used)
        ran = " and no kernel ran there" if trace else ""
        raise UnusedCards(f"the cell asks for {len(cards.cards)} cards and the run used {len(used)}: the "
                          f"memory allocated on {unused} never rose{ran}")
    notes = {"build_s": ctx.build_s, "power": power_limit() if on_card else None, **runner.notes,
             "spans": ctx.spans}
    if ctx.stretch is not None and ctx.chips > 1:
        notes["busy_s_per_card"] = ctx.stretch.busy_per_card()
        notes["idle_share_per_card"] = ctx.stretch.idle_shares()
    traces = torch.stack([s[3] for s in solves]).to("cpu", torch.float64)
    solves = [(k, n, r, traces[i]) for i, (k, n, r, _) in enumerate(solves)]
    samples = [(i, k, runner.to_input_basis(x)) for i, k, x in sample.items]
    del runner, sample
    if on_card:
        torch.cuda.empty_cache()
    matvec = reference.matvec(config["reference"], problem, torch.float64, devices[0])
    refs = [cg(matvec, b.to(torch.float64), problem.x0.to(torch.float64), max_iter=config["max_iter"],
               tolerance=config["tolerance"]) for b in problem.rhs]
    verdict = check.compare(solves, refs, samples, limits)
    out = {"correct": verdict["correct"], "attempted": len(solves), "failed": verdict["failed"],
           "metrics": {}, "device": dev_info}
    for entry in bench.metrics(cell_name, trace):
        value = bench.reader(entry["name"])(ctx)
        if value is not None:
            out["metrics"][entry["name"]] = {"value": value, "unit": entry["unit"]}
    if trace and ctx.stretch is not None:
        out["breakdown"] = {"device_ops": ctx.stretch.device_ops, "idle_gaps": ctx.stretch.idle_gaps}
    out["notes"] = notes
    out["checks"] = verdict["numbers"]
    return out


def forbidden_modules() -> list:
    return sorted({name for name in list(sys.modules) if name.split(".")[0] in FORBIDDEN})


def print_checks(numbers: dict) -> None:
    for name, n in numbers.items():
        ok = "ok" if n["value"] <= n["limit"] else "FAILS"
        print(f"check {name} {n['value']!r} limit {n['limit']!r} {ok}", file=sys.stderr)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = Bench()
    chips = int(bench.cell(args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"hpcbench: the cell needs {chips} NVIDIA GPU(s); torch.cuda sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    try:
        out = run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace))
    except UnusedCards as e:
        print(f"hpcbench: {e}", file=sys.stderr)
        return 1
    loaded = forbidden_modules()
    if loaded:
        print(f"hpcbench: modules of JAX or the JAX package were loaded: {', '.join(loaded)}", file=sys.stderr)
        return 3
    print_checks(out["checks"])
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
