"""grouped_matmul_roofline (%): the grouped expert kernels' bound over their
device time in the traced window, wherever the host launched them from.

The time is the profiler's sum over the kernels named ``grouped_kernel``
(``csrc/grouped_matmul.cu``: gate+up and down, two a MoE layer call) that
start between the first of the spans below and the end of the last, put
on the device's clock (``spans.on_device``).  It holds the launches of a
decode step replayed from a CUDA graph, which runs no span of the layer's
own, and leaves out those of the ticks that the window's open and close
cut, whose spans are dropped.  A kernel is not tied to the span it starts
in: the clock fit can move a span's start past its first kernel's.  The
bound adds max(FLOPs / bf16 peak, bytes / HBM peak)
(``layer_counts.expert_flops``, ``expert_bytes``) of every MoE layer call
in those spans:

  * a call the host made, inside a ``moe.experts`` span: its ``experts``
    and ``rows``;
  * each MoE layer of a replayed decode step (a ``step.decode`` span with
    ``graph`` 1), which records no span of its own: the step decodes every
    slot, so ``slots`` x ``top_k`` rows, and min(``n_experts``, rows)
    experts, every expert where the rows outnumber them.

Read from the program's spans: only in a traced run of a program that has
them."""
import re

import numpy as np

from bench import counts, layer_counts, spans

KERNELS = r"grouped_kernel"
PEAK_FLOPS = 989e12      # H100 SXM, bf16 dense, data sheet (at a 700 W power limit)
PEAK_BYTES_S = 3.35e12   # H100 SXM HBM3, data sheet


def _bound(model: dict, experts: int, rows: int) -> float:
    return max(layer_counts.expert_flops(model, rows) / PEAK_FLOPS,
               layer_counts.expert_bytes(model, experts, rows) / PEAK_BYTES_S)


def read(m):
    if m.trace is None or not m.trace.names or m.model.get("moe") is None:
        return None
    sp = spans.read(m)
    if sp is None:
        return None
    calls = sp.of("moe.experts")
    replays = sp.of("step.decode") & np.array([a.get("graph") == 1 for a in sp.attrs])
    idx = np.nonzero(calls | replays)[0]
    if not len(idx):
        return None
    bound = sum(_bound(m.model, a["experts"], a["rows"]) for a, h in zip(sp.attrs, calls) if h)
    if replays.any():
        moe = m.model["moe"]
        rows = m.mix["engine"]["slots"] * moe["top_k"]
        layers = sum(k == "attn_moe" for k in counts._kinds(m.model))
        bound += int(replays.sum()) * layers * _bound(m.model, min(moe["n_experts"], rows), rows)
    first, last = idx[np.argmin(sp.start[idx])], idx[np.argmax(sp.end[idx])]
    fit = spans.clock_fit(sp, m.trace)
    lo = spans.on_device(sp, fit, sp.start[first])
    hi = spans.on_device(sp, fit, sp.end[last], at=sp.start[last])
    rx = re.compile(KERNELS)
    named = np.array([bool(rx.search(n)) for n in m.trace.names], bool)
    inside = (m.trace.start >= lo) & (m.trace.start < hi)
    sec = float(m.trace.dur[named & inside].sum()) / 1e9
    return 100.0 * bound / sec if sec > 0 else None
