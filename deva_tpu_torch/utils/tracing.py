"""Spans and counters of the inference path, kept in memory.

Off by default; nothing in the package turns it on. A caller that wants
the host's time split by layer calls `enable()`, runs the port, then
`disable()` and `drain()`:

    tracing.enable()
    ...                       # step the port, usually under torch.profiler
    tracing.disable()
    records, counters = tracing.drain()
    print(tracing.summary(records), counters)

`span(name)` is a context manager. Off, it is one test of a module flag
and returns a shared no-op context: no profiler range, no clock read, no
allocation. On, it opens a `torch.profiler.record_function(name)` range,
so the span sits on the profiler's timeline beside the device work it
launched, and keeps a `Record(name, start_ns, end_ns, parent, step)`:
`parent` is the index of the enclosing span's record, `step` the id of the
enclosing `deva.step` (`step()`), so every span of one call shares an id.

The timestamps are read on the profiler's clock: CLOCK_REALTIME, in
nanoseconds since the epoch (`time.time_ns()`), the clock to which
torch.profiler converts its events' `start_ns()`. A record's start is read
just before its range opens and its end just after it closes, so a record
holds its range and its children's records.

`count(name, n)` adds n to a counter while tracing is on. Counters take
host integers (array sizes, byte counts): nothing here reads a device
value or waits on the device.

Spans are opened and closed by one thread, the one that steps the port.
Span names start with "deva.".
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

STEP = "deva.step"


class Record(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    parent: Optional[int]  # index of the enclosing span's record
    step: Optional[int]    # id of the enclosing deva.step


class _State:
    def __init__(self):
        self.records: List[list] = []  # [name, start, end, parent, step]
        self.counters: Dict[str, int] = defaultdict(int)
        self.open: List[int] = []       # indices of the open spans
        self.step: Optional[int] = None  # id of the open deva.step
        self.steps = 0                  # deva.step ids handed out


_on = False
_state = _State()
_OFF = contextlib.nullcontext()


class _Span:
    __slots__ = ("name", "rec", "range")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        s = _state
        if self.name == STEP:
            s.step, s.steps = s.steps, s.steps + 1
        self.rec = [self.name, 0, 0, s.open[-1] if s.open else None, s.step]
        s.open.append(len(s.records))
        s.records.append(self.rec)
        self.range = torch.profiler.record_function(self.name)
        self.rec[1] = time.time_ns()
        self.range.__enter__()
        return self

    def __exit__(self, *exc):
        self.range.__exit__(*exc)
        self.rec[2] = time.time_ns()
        s = _state
        s.open.pop()
        if self.name == STEP:
            s.step = None
        return False


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


def enabled() -> bool:
    return _on


def span(name: str):
    """A context around one layer's work (see the module note)."""
    if not _on:
        return _OFF
    return _Span(name)


def step():
    """`span("deva.step")` around one call of a stepping entry point; a
    call made inside another step's span opens none (the outermost call is
    the step)."""
    if not _on or _state.step is not None:
        return _OFF
    return _Span(STEP)


def count(name: str, n: int) -> None:
    """Add n (a host integer) to counter `name` while tracing is on."""
    if _on:
        _state.counters[name] += n


def drain() -> Tuple[List[Record], Dict[str, int]]:
    """The records and counters kept since the last drain, then forgets
    them. Call it with no span open."""
    s = _state
    if s.open:
        raise RuntimeError(f"drain() inside {len(s.open)} open span(s)")
    records = [Record(*r) for r in s.records]
    counters = dict(s.counters)
    s.records.clear()
    s.counters.clear()
    return records, counters


def summary(records: List[Record]) -> Dict[str, dict]:
    """Per span name: calls, host_ms (the spans' total duration) and
    self_ms (the duration less what the spans' children cover)."""
    covered = [0] * len(records)
    for r in records:
        if r.parent is not None:
            covered[r.parent] += r.end_ns - r.start_ns
    out: Dict[str, dict] = {}
    for r, child_ns in zip(records, covered):
        row = out.setdefault(r.name, {"calls": 0, "host_ms": 0.0,
                                      "self_ms": 0.0})
        row["calls"] += 1
        row["host_ms"] += (r.end_ns - r.start_ns) / 1e6
        row["self_ms"] += (r.end_ns - r.start_ns - child_ns) / 1e6
    return out
