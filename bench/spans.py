"""The program's own spans (``repro_torch.runtime.trace``) in a run's
window, for the per-layer metrics that read them.

The program records spans exactly while a ``torch.profiler`` profile
records, so they exist only in ``--trace 1`` runs, and only in a program
that has the recorder: without it, or with no span in the window, ``read``
returns None and the metric is left out of the result line.

Only spans lying wholly inside the window ``[open, close)`` count: the
tick that the close cuts is dropped by the program, and spans that an
earlier recording in the same process left behind lie outside.  Times are
``perf_counter`` nanoseconds, the harness's token clock; the recording's
anchor (``to_epoch``) and ``clock_fit`` put them on the profiler's clock.

Span names and attributes (set in ``launch/scheduler.py``, ``models/``):
``engine.tick`` (rows, admits, chunks), ``engine.admit`` and
``engine.chunk`` (tokens), ``step.prefill``, ``step.decode`` (rows) and
``sync`` (site): every place where the host waits for the device.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

STEPS = ("step.prefill", "step.decode")
FIT_NS = 1_000_000        # the largest correction of the clock ``clock_fit`` looks for
FIT_SYNCS = 32            # sync spans in each piece of the clock fit


class Spans:
    """The window's spans as arrays: ``name``, ``start``, ``end`` (ns) and
    ``attrs``, in the order they ended."""

    def __init__(self, rec, open_s: float, close_s: float):
        lo, hi = round(open_s * 1e9), round(close_s * 1e9)
        keep = [s for s in rec.spans if s.start >= lo and s.end <= hi]
        self.rec, self.lo, self.hi = rec, lo, hi
        self.name = np.array([s.name for s in keep], dtype=object)
        self.start = np.array([s.start for s in keep], np.int64)
        self.end = np.array([s.end for s in keep], np.int64)
        self.attrs = [s.attrs for s in keep]

    def __len__(self) -> int:
        return len(self.name)

    def of(self, *names) -> np.ndarray:
        return np.isin(self.name, names) if len(self) else np.zeros(0, bool)

    def lengths(self, *names) -> np.ndarray:
        hit = self.of(*names)
        return self.end[hit] - self.start[hit]

    def total(self, key: str, *names) -> int:
        """The sum of attribute ``key`` over the spans named ``names``."""
        return sum(a.get(key, 0) for a, h in zip(self.attrs, self.of(*names)) if h)

    def self_times(self, *names) -> np.ndarray:
        """Each span's length less the ``sync`` spans inside it."""
        hit = self.of(*names)
        a, b = self.start[hit], self.end[hit]
        sync = self.of("sync")
        s, e = self.start[sync], self.end[sync]
        order = np.argsort(s, kind="stable")
        s, e = s[order], e[order]
        cum = np.concatenate([[0], np.cumsum(e - s)])
        # the syncs do not overlap one another, so those inside [a, b] are
        # those that start in it
        i, j = np.searchsorted(s, a, "left"), np.searchsorted(s, b, "left")
        return (b - a) - (cum[j] - cum[i])


def read(m) -> Optional[Spans]:
    """The spans of the measured run ``m`` (``harness.Measured``) inside its
    window, or None where the program records none there."""
    try:
        from repro_torch.runtime import trace
    except ImportError:
        return None
    rec = trace.recording()
    if rec is None:
        return None
    sp = Spans(rec, m.run.open, m.run.close)
    return sp if len(sp) else None


def union(start, end):
    """Disjoint, sorted (starts, ends) covering the intervals [start, end)."""
    start, end = np.asarray(start, np.int64), np.asarray(end, np.int64)
    if not len(start):
        return start, end
    order = np.argsort(start, kind="stable")
    start, end = start[order], end[order]
    run_end = np.maximum.accumulate(end)
    new = np.concatenate([[True], start[1:] > run_end[:-1]])
    first = np.nonzero(new)[0]
    last = np.concatenate([first[1:] - 1, [len(start) - 1]])
    return start[first], run_end[last]


def _covers(points, s, e) -> np.ndarray:
    """For each point, whether it lies in one of the disjoint, sorted
    intervals (s, e)."""
    i = np.searchsorted(s, points, "right") - 1
    return (i >= 0) & (points < e[np.clip(i, 0, None)]) if len(s) else np.zeros(len(points), bool)


def _fit(ends, bs, be) -> int:
    """The shift nearest 0, within ``FIT_NS``, under which the most of
    ``ends`` (ns) fall in no busy stretch (bs, be)."""
    # the idle gaps [gs, ge) around the busy stretches, the outer two open
    gs = np.concatenate([[ends.min() - 2 * FIT_NS], be])
    ge = np.concatenate([bs, [ends.max() + 2 * FIT_NS]])
    first = np.searchsorted(ge, ends - FIT_NS, "right")
    last = np.searchsorted(gs, ends + FIT_NS, "right")
    n = last - first
    who = np.repeat(np.arange(len(ends)), n)
    gap = np.repeat(first - np.concatenate([[0], np.cumsum(n)[:-1]]), n) + np.arange(n.sum())
    # each end is idle for the shifts [gs - end, ge - end)
    a = np.clip(gs[gap] - ends[who], -FIT_NS, FIT_NS + 1)
    b = np.clip(ge[gap] - ends[who], -FIT_NS, FIT_NS + 1)
    pos = np.concatenate([a, b])
    step = np.concatenate([np.ones(len(a), np.int64), -np.ones(len(b), np.int64)])
    order = np.lexsort((step, pos))
    pos, cover = pos[order], np.cumsum(step[order])
    seg = np.nonzero((cover == cover.max()) & (np.diff(pos, append=pos[-1]) > 0))[0]
    near = np.clip(0, pos[seg], pos[seg + 1] - 1)
    return int(near[np.argmin(np.abs(near))])


def clock_fit(sp: Spans, trace) -> tuple:
    """The correction (ns) to add to the spans once the anchor has put them
    on the profiler's clock, as (bounds, corrections): correction k holds
    for the host times up to ``bounds[k]``, the last one after them.

    The host returns from a wait only once the device has drained, so every
    ``sync`` span must end with no device operation running.  The
    profiler's device timestamps and the host's clock can part by tens of
    microseconds, most in a profile's first seconds, enough to put a span's
    end inside the operation it waited for.  So the ``sync`` spans, in the
    order they end, are cut into pieces of ``FIT_SYNCS``, and each piece
    takes the correction nearest 0, within ``FIT_NS``, under which the most
    of its spans end on an idle device."""
    bs, be = union(trace.start, trace.start + trace.dur)
    ends = np.sort(sp.end[sp.of("sync")])
    if not len(ends) or not len(bs):
        return np.zeros(0, np.int64), np.zeros(1, np.int64)
    pieces = np.array_split(ends, max(1, len(ends) // FIT_SYNCS))
    corr = np.array([_fit(sp.rec.to_epoch(p), bs, be) for p in pieces], np.int64)
    return np.array([p[-1] for p in pieces[:-1]], np.int64), corr


def on_device(sp: Spans, fit: tuple, x, at=None):
    """Host times ``x`` (perf ns) on the profiler's clock: the anchor, then
    the correction that ``fit`` holds at the host times ``at`` (default
    ``x``; a span's start, to move the whole span by one correction)."""
    bounds, corr = fit
    x = np.asarray(x, np.int64)
    return sp.rec.to_epoch(x) + corr[np.searchsorted(bounds, x if at is None else at, "left")]


def idle_split(sp: Spans, trace) -> dict:
    """Nanoseconds of the window in which no device operation runs, split by
    what the host is doing then: ``dispatch`` (inside a step, in no
    ``sync``), ``engine`` (inside an ``engine.tick``, in no step and no
    ``sync``), ``sync`` and ``outside`` (in no tick).

    The device operations are the trace's, their union as
    ``device_idle_share`` takes it; the spans go onto the profiler's clock
    through the anchor and ``clock_fit``.  ``device_idle_share`` counts
    every operation the profiler caught against the window, also those of
    the cut tick after the close, so the split gives up as much idle time
    at the window's end (the cut tick's, whose spans are dropped) and its
    parts add up to the idle time that ``device_idle_share`` reads."""
    fit = clock_fit(sp, trace)
    lo, hi = (int(on_device(sp, fit, t)) for t in (sp.lo, sp.hi))
    bs, be = union(trace.start, trace.start + trace.dur)
    busy_in = np.clip(np.minimum(be, hi) - np.maximum(bs, lo), 0, None).sum()
    beyond = int((be - bs).sum() - busy_in)
    # the idle stretches inside the window, from its end backwards, until
    # ``beyond`` of idle is given up
    cs, ce = np.clip(bs, lo, hi), np.clip(be, lo, hi)
    gap_s = np.concatenate([[lo], ce])
    gap_e = np.concatenate([cs, [hi]])
    keep = gap_e > gap_s
    gap_s, gap_e = gap_s[keep], gap_e[keep]
    cut = hi
    for s, e in zip(gap_s[::-1], gap_e[::-1]):
        if beyond <= 0:
            break
        take = min(beyond, e - s)
        cut, beyond = e - take, beyond - take
    cut = max(int(cut), lo)

    start, end = on_device(sp, fit, sp.start), on_device(sp, fit, sp.end, at=sp.start)
    sync, step, tick = (union(start[sp.of(*names)], end[sp.of(*names)])
                        for names in (("sync",), STEPS, ("engine.tick",)))
    points = np.unique(np.concatenate([[lo, cut], bs, be, *sync, *step, *tick]))
    points = points[(points >= lo) & (points < cut)]
    width = np.diff(np.concatenate([points, [cut]]))
    idle = ~_covers(points, bs, be)
    in_sync, in_step, in_tick = (_covers(points, *x) for x in (sync, step, tick))
    parts = {"dispatch": in_step & ~in_sync,
             "engine": in_tick & ~in_step & ~in_sync,
             "sync": in_sync,
             "outside": ~in_tick & ~in_step & ~in_sync}
    return {k: int(width[idle & v].sum()) for k, v in parts.items()}
