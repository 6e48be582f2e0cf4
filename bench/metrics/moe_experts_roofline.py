"""moe_experts_roofline (%): the grouped expert products' bound over their
device time in the traced window.  Each of the program's ``moe.experts``
spans inside the window (one MoE layer call's gate, up and down products)
adds max(FLOPs / bf16 peak, bytes / HBM peak) of its ``experts`` and
``rows`` (``layer_counts.expert_flops``, ``expert_bytes``); the time is
the device time of the operations that start inside those spans, put on
the device's clock (``spans.on_device``).  Read from the program's spans:
only in a traced run of a program that has them."""
from bench import layer_counts, spans

PEAK_FLOPS = 989e12      # H100 SXM, bf16 dense, data sheet (at a 700 W power limit)
PEAK_BYTES_S = 3.35e12   # H100 SXM HBM3, data sheet


def read(m):
    if m.trace is None or not m.trace.names or m.model.get("moe") is None:
        return None
    sp = spans.read(m)
    if sp is None or not sp.of("moe.experts").any():
        return None
    hit = sp.of("moe.experts")
    bound = 0.0
    for a, h in zip(sp.attrs, hit):
        if h:
            bound += max(layer_counts.expert_flops(m.model, a["rows"]) / PEAK_FLOPS,
                         layer_counts.expert_bytes(m.model, a["experts"], a["rows"])
                         / PEAK_BYTES_S)
    fit = spans.clock_fit(sp, m.trace)
    s, e = spans.union(spans.on_device(sp, fit, sp.start[hit]),
                       spans.on_device(sp, fit, sp.end[hit], at=sp.start[hit]))
    inside = spans._covers(m.trace.start, s, e)
    sec = float(m.trace.dur[inside].sum()) / 1e9
    return 100.0 * bound / sec if sec > 0 else None
