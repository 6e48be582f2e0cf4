"""The reader ``grouped_matmul_roofline`` on the hand-made spans, records and
device trace of ``test_bench_layer_counts.py`` (its docstring works out the
window): every device operation there is made a grouped kernel, and a decode
step is added, eager with a ``moe.experts`` span of its own or replayed
from a CUDA graph with none."""
import pytest

import bench_tiny
from bench import layer_counts
from test_bench_layer_counts import MODEL, OPS, SPANS, _measured, _read, _recording, recorded  # noqa: F401

GROUPED = "void gm::grouped_kernel<16, true, false>(CUtensorMap, CUtensorMap)"


def _bound(calls):
    return sum(max(layer_counts.expert_flops(MODEL, r) / 989e12,
                   layer_counts.expert_bytes(MODEL, e, r) / 3.35e12) for e, r in calls)


@pytest.mark.parametrize("replayed", [False, True], ids=["eager", "replayed"])
def test_grouped_matmul_roofline_counts_the_replayed_decode(recorded, replayed):
    """Every op a grouped kernel: ops 1 and 2 in the first ``moe.experts``
    span, op 4 in the second, op 3 (1 ms) in a decode step, op 0 before
    the first counted span (a tick that the window's open cut: left out).
    Eager, the step runs the layer's own span; replayed from the graph it
    runs none, and each of its 4 MoE layers counts 3 slots x top-2 = 6 rows
    over 6 of the 8 experts."""
    decode = [("moe.experts", 5.0, 6.0, {"experts": 5, "rows": 6})]
    if replayed:
        decode = [("step.decode", 4.5, 6.5, {"rows": 3, "graph": 1})]
    recorded(_recording(SPANS + decode))
    m = _measured([GROUPED] * len(OPS))
    m.mix = {"engine": {"slots": 3}}
    spanned = [(3, 8), (2, 8)]
    step = [(6, 6)] * 4 if replayed else [(5, 6)]
    assert _read("grouped_matmul_roofline", m) == pytest.approx(
        100 * _bound(spanned + step) / 2.1e-3, rel=1e-9)
    # the reader bound to the spans sees a replayed step's kernels no more
    want = _bound(spanned) / 1.1e-3 if replayed else _bound(spanned + step) / 2.1e-3
    assert _read("moe_experts_roofline", m) == pytest.approx(100 * want, rel=1e-9)


def test_grouped_matmul_roofline_keeps_a_kernel_that_starts_before_its_span(recorded):
    """The clock fit can put a span's start past its first kernel's: op 4
    (8.0 ms) then starts before its ``moe.experts`` span (8.1 ms), and is
    still counted, as it lies between the first counted span and the last."""
    late = [(n, 8.1, b, a) if n == "moe.experts" and s == 7.5 else (n, s, b, a)
            for n, s, b, a in SPANS]
    recorded(_recording(late))
    m = _measured([GROUPED, GROUPED, GROUPED, "op3", GROUPED])
    # ops 1, 2 and 4: 0.4 + 0.2 + 0.5 ms; op 0 before the first span
    assert _read("grouped_matmul_roofline", m) == pytest.approx(
        100 * _bound([(3, 8), (2, 8)]) / 1.1e-3, rel=1e-9)


def test_without_grouped_kernels_spans_or_a_moe_model_it_reads_none(recorded):
    # a program without the MoE layer's spans or the decode's graph attribute
    recorded(_recording([s for s in SPANS if not s[0].startswith("moe.")]))
    assert _read("grouped_matmul_roofline", _measured([GROUPED] * len(OPS))) is None
    # no grouped kernel in the trace, no MoE model, no trace
    recorded(_recording())
    assert _read("grouped_matmul_roofline", _measured()) is None
    assert _read("grouped_matmul_roofline", _measured(model=bench_tiny.DENSE)) is None
    m = _measured([GROUPED] * len(OPS))
    m.trace = None
    assert _read("grouped_matmul_roofline", m) is None
    # no recording at all
    recorded(None)
    assert _read("grouped_matmul_roofline", _measured([GROUPED] * len(OPS))) is None
