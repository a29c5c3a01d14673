"""The benchmark's metric arithmetic, and the readers found by name.

Every metric of ``BENCHMARK.json`` has a reader of its own here, the file
``<name>.py`` with ``read(ctx) -> float | None``: ``ctx`` is the run's
:class:`hpcbench.run.Context`. A reader that finds nothing to read returns
None, and the harness leaves the metric out of the result line.
"""

from __future__ import annotations

import importlib.util
import math
import statistics
from pathlib import Path

HERE = Path(__file__).resolve().parent


def stencil27_nnz(nx: int, ny: int, nz: int) -> int:
    """Stored nonzeros of the 27-point matrix on an nx x ny x nz grid: a
    row's neighbours inside the grid, (3n - 2) along each axis summed."""
    return (3 * nx - 2) * (3 * ny - 2) * (3 * nz - 2)


def least_bytes_per_iter(n: int, nnz: int, itemsize: int, explicit: bool) -> int:
    """The fewest bytes one CG iteration moves to and from memory, whatever
    implements it: x, r and p each read and written once, and for an
    explicit matrix each stored value read once. Indices, padding and
    intermediates (Ap) are left out, so an implementation that reads each
    value and the state once cannot read above it."""
    return 6 * itemsize * n + (itemsize * nnz if explicit else 0)


def p95(values) -> float:
    """The 95th percentile, interpolated between order statistics (Python's
    ``statistics.quantiles``, inclusive method)."""
    values = list(values)
    if len(values) == 1:
        return float(values[0])
    return statistics.quantiles(values, n=20, method="inclusive")[18]


def union(intervals) -> list:
    """The union of (start, end) intervals, as sorted disjoint intervals."""
    merged = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return [tuple(iv) for iv in merged]


def covered(intervals, lo: float, hi: float) -> float:
    """How much of [lo, hi] the union of ``intervals`` covers."""
    return sum(max(0.0, min(e, hi) - max(s, lo)) for s, e in union(intervals))


def idle_share(intervals, lo: float, hi: float) -> float:
    """1 - (the part of [lo, hi] the device was busy) / (hi - lo)."""
    if not hi > lo:
        raise ValueError("empty window")
    return 1.0 - covered(intervals, lo, hi) / (hi - lo)


def finite(value):
    """``value`` if it is a finite number, else None."""
    return value if value is not None and math.isfinite(value) else None


def reader(name: str, base: Path = HERE):
    """The ``read`` function of metric ``name`` (the file ``<name>.py`` in
    ``base``)."""
    path = base / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"metric {name!r} has no reader {path}")
    spec = importlib.util.spec_from_file_location("hpcbench_metric_" + name.replace(".", "_").replace("-", "_"),
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
