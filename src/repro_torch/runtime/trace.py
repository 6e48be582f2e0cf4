"""Spans on the host's clock, recorded while a ``torch.profiler`` profile
records in this process.

    with trace.span("step.decode", rows=8) as sp:
        ...
        sp.set(tokens=n)            # an attribute known only inside

A span is a name, a start and an end on ``time.perf_counter_ns()``, the id
of the span that held it when it began (-1 for none) and a few attributes.
There is no switch of its own: spans are kept exactly while the profiler
records (``torch._C._autograd._profiler_enabled()``), so a traced window
holds both the device's operations and the host's spans, and nothing else
turns it on.  With the profiler off a span costs that one check.

The first span that finds the profiler on, where the span before it found
it off, starts a new recording and drops the last one (two profiles with no
span between them share one).  A recording stores one anchor, a
``perf_counter_ns()`` and a ``time.time_ns()`` read back to back: the
profiler stamps its events in Unix-epoch nanoseconds, so ``to_epoch`` puts
a span on the device operations' time line.  A span that an exception cuts
(a window closed from inside a callback, a failed step) is not kept.

The serving engine and the model step report through ``span`` (names and
attributes in ``launch/scheduler.py``); ``sync`` spans wrap every place on
the serving path where the host waits for the device, with ``site`` naming
the place.
"""
from __future__ import annotations

import time
from typing import List, Optional

import torch

_profiling = torch._C._autograd._profiler_enabled
_now = time.perf_counter_ns


class Span:
    __slots__ = ("id", "name", "start", "end", "parent", "attrs")

    def __init__(self, sid: int, name: str, parent: int, attrs: dict):
        self.id, self.name, self.parent, self.attrs = sid, name, parent, attrs
        self.start = self.end = 0

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)


class Recording:
    """The spans of one profiler run: ``spans`` in the order they
    ended, ``open`` the spans begun and not yet ended, innermost last."""

    def __init__(self):
        self.anchor_perf_ns = _now()
        self.anchor_epoch_ns = time.time_ns()
        self.spans: List[Span] = []
        self.open: List[Span] = []
        self.begun = 0                  # spans begun, the next span's id

    def to_epoch(self, perf_ns):
        """``perf_counter`` nanoseconds (an int or a numpy array) on the
        profiler's Unix-epoch clock."""
        return perf_ns - self.anchor_perf_ns + self.anchor_epoch_ns


class _Off:
    """The span handed out while the profiler is off: it records nothing."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> None:
        pass


_OFF = _Off()
_rec: Optional[Recording] = None    # the current recording, or the last one
_on = False                         # the profiler was on at the last span


class _On:
    __slots__ = ("rec", "span")

    def __init__(self, rec: Recording, name: str, attrs: dict):
        parent = rec.open[-1].id if rec.open else -1
        self.rec, self.span = rec, Span(rec.begun, name, parent, attrs)
        rec.begun += 1

    def __enter__(self) -> Span:
        self.rec.open.append(self.span)
        self.span.start = _now()
        return self.span

    def __exit__(self, exc_type, *exc):
        end = _now()
        self.rec.open.pop()
        if exc_type is None:
            self.span.end = end
            self.rec.spans.append(self.span)
        return False


def span(name: str, **attrs):
    """A context manager that records the span ``name`` with ``attrs`` while
    a profiler records, and does nothing otherwise."""
    global _on, _rec
    if not _profiling():
        _on = False
        return _OFF
    if not _on:
        _rec, _on = Recording(), True
    return _On(_rec, name, attrs)


def recording_now() -> bool:
    """Whether a profile records now, so that spans are kept."""
    return _profiling()


def recording() -> Optional[Recording]:
    """The current recording, or the last one; None before the first."""
    return _rec
