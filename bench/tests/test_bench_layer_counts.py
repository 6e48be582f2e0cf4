"""``bench/layer_counts.py`` against hand counts and ``counts.py``, and the
readers ``idle_moe_share``, ``moe_experts_roofline``,
``mixed_paged_roofline`` and ``mixed_flash_roofline`` on hand-made spans,
records and a hand-made device trace.

The hand-made window is [1, 11) ms on the host's clock.  Device operations
(host ms): [1.0, 2.0], [2.6, 3.0], [3.2, 3.4], [5.0, 6.0], [8.0, 8.5].
Spans (host ms):

    moe.ffn [2.0, 4.0] rows 4
      sync [2.1, 2.5] moe_sizes
      moe.experts [2.5, 3.5] experts 3, rows 8     ops starting in it: 0.4 + 0.2 ms
    moe.ffn [7.0, 9.0] rows 4
      sync [7.2, 7.5] moe_sizes
      moe.experts [7.5, 8.8] experts 2, rows 8     ops starting in it: 0.5 ms

Idle inside an MoE layer and out of its sync: [2.0, 2.1], [2.5, 2.6],
[3.0, 3.2], [3.4, 4.0], [7.0, 7.2], [7.5, 8.0], [8.5, 9.0] = 2.2 ms of the
10 ms window: 22%.
"""
import types

import numpy as np
import pytest

import bench_tiny
from bench import counts, layer_counts, records, spec
from bench.trace import Trace
from repro_torch.runtime import trace

MS = 1_000_000
ANCHOR_PERF = 123_456
ANCHOR_EPOCH = 1_700_000_000_000_000_000
OPS = [(1.0, 2.0), (2.6, 3.0), (3.2, 3.4), (5.0, 6.0), (8.0, 8.5)]
SPANS = [  # name, start, end, attrs (host ms), in the order they end
    ("sync", 2.1, 2.5, {"site": "moe_sizes"}),
    ("moe.experts", 2.5, 3.5, {"experts": 3, "rows": 8}),
    ("moe.ffn", 2.0, 4.0, {"rows": 4}),
    ("sync", 7.2, 7.5, {"site": "moe_sizes"}),
    ("moe.experts", 7.5, 8.8, {"experts": 2, "rows": 8}),
    ("moe.ffn", 7.0, 9.0, {"rows": 4}),
]
MODEL = {"n_layers": 4, "d_model": 64, "n_heads": 8, "n_kv_heads": 2, "head_dim": 32,
         "d_ff": 128, "vocab": 256, "block_pattern": ["attn_moe"],
         "layer_windows": [16, 16, 16, None],
         "moe": {"n_experts": 8, "top_k": 2, "d_ff_expert": 32}}


def _read(name, m):
    return spec.reader(name)(m)


def _recording(spans=SPANS) -> trace.Recording:
    rec = trace.Recording()
    rec.anchor_perf_ns, rec.anchor_epoch_ns = ANCHOR_PERF, ANCHOR_EPOCH
    for i, (name, a, b, attrs) in enumerate(spans):
        sp = trace.Span(i, name, -1, dict(attrs))
        sp.start, sp.end = round(a * MS), round(b * MS)
        rec.spans.append(sp)
    return rec


def _measured(names=None, model=MODEL):
    run = types.SimpleNamespace(open=1e-3, close=11e-3, window_s=10e-3)
    start = [round(a * MS) - ANCHOR_PERF + ANCHOR_EPOCH for a, _ in OPS]
    dur = [round((b - a) * MS) for a, b in OPS]
    tr = Trace(names or [f"op{i}" for i in range(len(OPS))], start, dur, run.window_s)
    return types.SimpleNamespace(run=run, trace=tr, model=model, mix={})


@pytest.fixture
def recorded(monkeypatch):
    def use(rec):
        monkeypatch.setattr(trace, "_rec", rec)
    return use


def test_hand_counts():
    assert layer_counts.windows(MODEL) == [16, 16, 16, None]
    # rows of 10 and 40 tokens: three window layers read 10 + 16 slots, the
    # full layer 10 + 40; K+V 2*2*32 elements a slot, q+out 2*8*32 a row
    kv, q = 2 * 2 * 32, 2 * 8 * 32
    assert layer_counts.paged_decode_bytes(MODEL, [10, 40]) == 2 * (
        3 * (26 * kv + 2 * q) + (50 * kv + 2 * q))
    assert layer_counts.expert_flops(MODEL, 8) == 2 * 3 * 64 * 32 * 8
    # a prompt of 40: three window layers see 16 * 17 / 2 + 24 * 16 pairs,
    # the full layer 40 * 41 / 2; q, k, v, out (8 + 2 + 2 + 8) * 32 a token
    assert layer_counts.flash_prefill(MODEL, 40) == (
        4 * 32 * 8 * (3 * (136 + 24 * 16) + 820), 4 * 40 * 32 * 20 * 2)
    assert layer_counts.expert_bytes(MODEL, 3, 8) == 2 * (3 * 3 * 64 * 32 + 2 * 8 * 64)


@pytest.mark.parametrize("name", ["chatglm3-6b", "tiny", "tinymoe"])
def test_without_per_layer_windows_it_is_the_paged_count(name):
    if name == "chatglm3-6b":
        model = spec.config(spec.benchmark(bench_tiny.REPO), name, bench_tiny.REPO)["model"]
    else:
        model = bench_tiny.DENSE if name == "tiny" else bench_tiny.MOE
    lengths = [1, 17, 300, 5000]
    w = model.get("window")          # the tiny MoE model's one window of 128
    assert layer_counts.windows(model) == [w] * model["n_layers"]
    # counts.paged_decode_bytes reads every row whole: a ring holds the
    # last w of its tokens
    assert layer_counts.paged_decode_bytes(model, lengths) == \
        counts.paged_decode_bytes(model, [n if w is None else min(n, w) for n in lengths])
    for n in lengths:
        assert layer_counts.flash_prefill(model, n) == counts.flash_prefill(model, n)


def test_hand_worked_window(recorded):
    recorded(_recording())
    m = _measured()
    assert _read("idle_moe_share", m) == pytest.approx(22.0, rel=1e-9)
    bound = sum(max(layer_counts.expert_flops(MODEL, r) / 989e12,
                    layer_counts.expert_bytes(MODEL, e, r) / 3.35e12)
                for e, r in ((3, 8), (2, 8)))
    assert _read("moe_experts_roofline", m) == pytest.approx(100 * bound / 1.1e-3, rel=1e-9)


def test_without_moe_spans_or_a_trace_the_moe_readers_read_none(recorded):
    # a program without the MoE layer's spans (the parent of this change)
    recorded(_recording([s for s in SPANS if not s[0].startswith("moe.")]))
    assert _read("idle_moe_share", _measured()) is None
    assert _read("moe_experts_roofline", _measured()) is None
    recorded(_recording())
    m = _measured()
    m.trace = None
    assert _read("idle_moe_share", m) is None and _read("moe_experts_roofline", m) is None
    recorded(None)
    assert _read("idle_moe_share", _measured()) is None


def test_mixed_paged_roofline_counts_each_layers_window():
    """Three requests, prompts 1, 20 and 3 tokens, a token a clock tick in
    turn; the window opens at the first request's second and last token,
    t = 4, and holds the decode tokens at t = 4..8: rows of 2, 21, 4, 22
    and 5 tokens."""
    clock = iter(np.arange(1.0, 100.0, 1.0))
    rec = records.Recorder([2, 6, 6], 1, 4.5, clock=lambda: float(next(clock)))
    for rid in [0, 1, 2, 0, 1, 2, 1, 2, 1]:
        try:
            rec.on_token(rid, 7)
        except records.WindowClosed:
            break
    run = records.Run(rec, [1, 20, 3], 3)
    dec = run.inside(run.t) & (run.idx > 0)
    lengths = (run.prompt_lens[run.rid[dec]] + run.idx[dec]).tolist()
    assert sorted(lengths) == [2, 4, 5, 21, 22]
    names = ["void paged_attention_split<bf16>", "void paged_attention_combine", "gemm", "x",
             "y"]
    m = _measured(names)
    m.run = run
    sec = (1.0 + 0.4) * 1e-3      # the split and combine operations' durations
    want = 100 * layer_counts.paged_decode_bytes(MODEL, lengths) / 3.35e12 / sec
    assert _read("mixed_paged_roofline", m) == pytest.approx(want, rel=1e-6)
    # fewer bytes than the full rows that paged_attn_roofline counts
    assert _read("mixed_paged_roofline", m) < _read("paged_attn_roofline", m)
    m.trace = Trace(["gemm"], [0], [1], 1.0)
    assert _read("mixed_paged_roofline", m) is None


def test_mixed_flash_roofline_counts_each_layers_window():
    """Five requests of two tokens, prompts 1, 20, 3, 20 and 30, a token a
    clock tick; the window opens at t = 4 (request 0 done) and closes at
    8.5, so it holds the first tokens of requests 3 and 4 (t = 5, 6):
    prompts 20 and 30."""
    clock = iter(np.arange(1.0, 100.0, 1.0))
    rec = records.Recorder([2, 2, 2, 2, 2], 1, 4.5, clock=lambda: float(next(clock)))
    for rid in [0, 1, 2, 0, 3, 4, 3, 4, 1]:
        try:
            rec.on_token(rid, 7)
        except records.WindowClosed:
            break
    run = records.Run(rec, [1, 20, 3, 20, 30], 5)
    firsts = np.nonzero(run.inside(run.first))[0]
    assert sorted(run.prompt_lens[firsts].tolist()) == [20, 30]
    names = ["tc::flash_kernel<128>", "x", "flash_attention_kernel<float>", "y", "z"]
    m = _measured(names)
    m.run = run
    sec = (1.0 + 0.2) * 1e-3      # the two flash operations' durations
    bound = 0.0
    for n in (20, 30):
        flops, nbytes = layer_counts.flash_prefill(MODEL, n)
        bound += max(flops / 989e12, nbytes / 3.35e12)
    assert _read("mixed_flash_roofline", m) == pytest.approx(100 * bound / sec, rel=1e-6)
    # no more than the pairs that flash_attn_roofline counts with no window
    assert _read("mixed_flash_roofline", m) <= _read("flash_attn_roofline", m)
    m.trace = Trace(["gemm"], [0], [1], 1.0)
    assert _read("mixed_flash_roofline", m) is None
