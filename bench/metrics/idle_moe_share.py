"""idle_moe_share (%): the share of the traced window in which no device
operation runs while the host is inside an MoE layer (a ``moe.ffn`` span)
and in none of its ``sync`` spans: the host's dispatch of the routing and
the per-expert products, with the device waiting.  The device's
operations and their union as ``device_idle_share`` takes them; the
program's spans on the same clock (``bench/spans.py``)."""
import numpy as np

from bench import spans


def read(m):
    if m.trace is None or not m.trace.names:
        return None
    sp = spans.read(m)
    if sp is None or not sp.of("moe.ffn").any():
        return None
    fit = spans.clock_fit(sp, m.trace)
    lo, hi = (int(spans.on_device(sp, fit, t)) for t in (sp.lo, sp.hi))
    bs, be = spans.union(m.trace.start, m.trace.start + m.trace.dur)
    start = spans.on_device(sp, fit, sp.start)
    end = spans.on_device(sp, fit, sp.end, at=sp.start)
    moe = spans.union(start[sp.of("moe.ffn")], end[sp.of("moe.ffn")])
    sync = spans.union(start[sp.of("sync")], end[sp.of("sync")])
    points = np.unique(np.concatenate([[lo, hi], bs, be, *moe, *sync]))
    points = points[(points >= lo) & (points < hi)]
    width = np.diff(np.concatenate([points, [hi]]))
    idle = ~spans._covers(points, bs, be)
    here = spans._covers(points, *moe) & ~spans._covers(points, *sync)
    return 100.0 * float(width[idle & here].sum()) / 1e9 / m.trace.window_s
