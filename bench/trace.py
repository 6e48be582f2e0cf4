"""The device's side of a traced window, from ``torch.profiler``'s events.

The profiler records the device only (CUDA activity: kernels, copies and
sets), from the window's open to its close.  Each device operation is a
(name, start, duration); the busy time is the union of their intervals, so
overlapping streams count once.
"""
from __future__ import annotations

import re
from typing import List, Optional

import numpy as np

NAME_CHARS = 120      # a demangled kernel name is cut to this length


class Trace:
    def __init__(self, names: List[str], start_ns, dur_ns, window_s: float):
        self.names = names
        self.start = np.asarray(start_ns, np.int64)
        self.dur = np.asarray(dur_ns, np.int64)
        self.window_s = window_s

    @classmethod
    def from_profiler(cls, prof, window_s: float) -> "Trace":
        names, start, dur = [], [], []
        for e in prof.profiler.kineto_results.events():
            if e.device_type().name != "CUDA":
                continue
            names.append(e.name())
            if hasattr(e, "start_ns"):
                start.append(e.start_ns())
                dur.append(e.duration_ns())
            else:
                start.append(int(e.start_us() * 1000))
                dur.append(int(e.duration_us() * 1000))
        order = np.argsort(np.asarray(start, np.int64), kind="stable")
        return cls([names[i] for i in order], np.asarray(start, np.int64)[order],
                   np.asarray(dur, np.int64)[order], window_s)

    def _segments(self):
        """The union of the operations' intervals as (starts, ends), and for
        each segment the indices of its first and last operation."""
        if not len(self.start):
            return np.zeros(0, np.int64), np.zeros(0, np.int64), [], []
        end = self.start + self.dur
        run_end = np.maximum.accumulate(end)
        new = np.concatenate([[True], self.start[1:] > run_end[:-1]])
        first = np.nonzero(new)[0]
        last = np.concatenate([first[1:] - 1, [len(self.start) - 1]])
        return self.start[first], run_end[last], first, last

    def busy_s(self) -> float:
        s, e, _, _ = self._segments()
        return float((e - s).sum()) / 1e9

    def seconds(self, pattern: str) -> Optional[float]:
        """Device seconds of the operations whose name matches ``pattern``;
        None when none ran."""
        rx = re.compile(pattern)
        hit = np.array([bool(rx.search(n)) for n in self.names], bool)
        return float(self.dur[hit].sum()) / 1e9 if hit.any() else None

    def top_ops(self, n: int = 10) -> list:
        """[name, seconds] of the ``n`` operation names with the most device
        time."""
        tot = {}
        for name, d in zip(self.names, self.dur.tolist()):
            tot[name] = tot.get(name, 0) + d
        best = sorted(tot.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:NAME_CHARS], d / 1e9] for name, d in best]

    def idle_gaps(self, n: int = 10) -> list:
        """[name, seconds] of the ``n`` longest stretches with nothing on the
        device, each named by the operations on either side of it."""
        s, e, first, last = self._segments()
        if len(s) < 2:
            return []
        gaps = s[1:] - e[:-1]
        out = []
        for i in np.argsort(-gaps, kind="stable")[:n]:
            before = self.names[last[i]][:NAME_CHARS // 2]
            after = self.names[first[i + 1]][:NAME_CHARS // 2]
            out.append([f"after {before} / before {after}", float(gaps[i]) / 1e9])
        return out
