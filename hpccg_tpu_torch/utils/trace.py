"""Spans of the port's phases, kept in memory.

``span(name)`` marks one interval of the host's work: the solver's phases
(``solver.solve``, ``solver.start``, ``solver.issue``, ``solver.exit_read``,
``solver.finish``, ``solver.prepare``) and the structure chooser's steps
(``reorder.*``). Each closed span is a :class:`Span`: its name, the index of
the span open around it in the same list (-1 at the top), and its start and
end on ``time.perf_counter_ns``. The records stay in one list until
``take()`` hands them over and clears it; there is no exporter. A count is
the number of spans of a name.

Tracing is off by default, and nothing here turns it on: a caller does,
with ``enable()``. Off, ``span`` returns one shared no-op context (no clock
read, no record, no profiler call), and the CG loops read ``enabled()``
once per solve. On, while a ``torch.profiler`` is recording, each span is
also a ``torch.profiler.record_function`` range, so it lies on the
profiler's timeline beside the device's events; outside a profiler a span
costs two clock reads and a record.

The recorder is one per process, as torch.profiler is: the spans sit in
library functions that take no recorder argument. Spans nest within one
thread.
"""

from __future__ import annotations

import functools
from contextlib import nullcontext
from time import perf_counter_ns
from typing import NamedTuple

import torch


class Span(NamedTuple):
    name: str
    parent: int  # index of the enclosing span in the same list, -1 at the top
    start: int  # ns, time.perf_counter_ns
    end: int


_OFF = nullcontext()
_on = False
_records: list = []
_open: list = []  # the open spans, innermost last


class _Open:
    """One span while it is open (tracing on). Its record's place in the
    list is taken on entry, so that spans opened inside it can name it."""

    __slots__ = ("name", "records", "index", "parent", "start", "annotation")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.annotation = None
        if torch.autograd.profiler._is_profiler_enabled:
            self.annotation = torch.profiler.record_function(self.name)
            self.annotation.__enter__()
        outer = _open[-1] if _open else None
        self.parent = outer.index if outer is not None and outer.records is _records else -1
        self.records, self.index = _records, len(_records)
        _records.append(None)
        _open.append(self)
        self.start = perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        end = perf_counter_ns()
        if _open and _open[-1] is self:
            _open.pop()
        elif self in _open:  # spans left open inside it (an exception) end with it
            at = _open.index(self)
            for inner in _open[at + 1:]:
                inner.records[inner.index] = Span(inner.name, inner.parent, inner.start, end)
            del _open[at:]
        self.records[self.index] = Span(self.name, self.parent, self.start, end)
        if self.annotation is not None:
            self.annotation.__exit__(*exc)
        return False


def enabled() -> bool:
    return _on


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


def take() -> list:
    """The spans recorded since the last ``take()``, in the order they
    opened; clears the list. Call it between spans: one still open holds
    its place in the list taken (None) until it ends."""
    global _records
    out, _records = _records, []
    return out


def span(name: str):
    """A context that records ``name`` from entry to exit while tracing is
    on, and does nothing while it is off."""
    return _Open(name) if _on else _OFF


def spanned(name: str):
    """A decorator: each call of the function runs inside ``span(name)``."""

    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return inner

    return wrap
