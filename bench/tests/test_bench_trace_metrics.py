"""The readers of the program's spans (``bench/spans.py`` and the metrics
``decode_step_ms_p50``, ``decode_dispatch_ms_p50``, ``prefill_us_per_tok``,
``idle_dispatch_share``, ``idle_engine_share``) on hand-made spans and a
hand-made device trace, with every value worked out by hand; then on a
profiled run of a tiny cell on the CPU.

The hand-made window is [1, 11) ms on the host's clock.  Device operations
(host ms): [1.0, 2.2], [3.0, 4.8] and [4.6, 5.2] (one busy stretch),
[6.7, 7.9], [8.7, 10.0], [10.7, 11.3]: busy 6.5 ms in all, 0.3 of it after
the close, so ``device_idle_share`` reads 35%.  The idle stretches in the
window, 3.8 ms, give up the last 0.3 ms ([10.4, 10.7]) for the busy time
after the close.  Spans (host ms):

    engine.tick  [0.5, 1.5]                 straddles the open: not counted
    step.decode  [0.2, 1.4]                 straddles the open: not counted
    engine.tick  [2, 6]
      step.decode  [2.5, 5.5]   syncs [2.5, 2.6], [4.5, 5.5]    self 1.9
    engine.tick  [6.5, 10.5]
      engine.admit [6.5, 8.5] tokens 100
        step.prefill [6.6, 7.6]   sync [7.6, 8.0]
      step.decode  [8.5, 10.0]  sync [9.5, 10.0]                self 1.0
                                (its end meets the end of the operation it waited for)
    engine.chunk [10.6, 10.8] tokens 32
    step.decode  [10.6, 11.2]               straddles the close: not counted

Idle while dispatching: [2.6, 3.0], [6.6, 6.7], [8.5, 8.7] = 0.7 ms (7%);
in the engine: [2.2, 2.5], [5.5, 6.0], [6.5, 6.6], [8.0, 8.5], [10.0, 10.4]
= 1.8 ms (18%); in a sync 0.5 ms, outside any tick ([6.0, 6.5]) 0.5 ms.
"""
import sys
import types

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile

import bench_tiny
from bench import harness, spans, spec
from bench.trace import Trace
from repro_torch.runtime import trace

MS = 1_000_000
ANCHOR_PERF = 123_456
ANCHOR_EPOCH = 1_700_000_000_000_000_000

OPS = [(1.0, 2.2), (3.0, 4.8), (4.6, 5.2), (6.7, 7.9), (8.7, 10.0), (10.7, 11.3)]
SPANS = [  # name, start, end, attrs (host ms), in the order they end
    ("step.decode", 0.2, 1.4, {"rows": 4}),
    ("engine.tick", 0.5, 1.5, {}),
    ("sync", 2.5, 2.6, {"site": "h2d"}),
    ("sync", 4.5, 5.5, {"site": "decode"}),
    ("step.decode", 2.5, 5.5, {"rows": 4}),
    ("engine.tick", 2.0, 6.0, {"rows": 4}),
    ("step.prefill", 6.6, 7.6, {}),
    ("sync", 7.6, 8.0, {"site": "first_token"}),
    ("engine.admit", 6.5, 8.5, {"tokens": 100}),
    ("sync", 9.5, 10.0, {"site": "decode"}),
    ("step.decode", 8.5, 10.0, {"rows": 5}),
    ("engine.tick", 6.5, 10.5, {"rows": 5}),
    ("engine.chunk", 10.6, 10.8, {"tokens": 32}),
    ("step.decode", 10.6, 11.2, {"rows": 5}),
]
READERS = ("decode_step_ms_p50", "decode_dispatch_ms_p50", "prefill_us_per_tok",
           "idle_dispatch_share", "idle_engine_share", "device_idle_share")
WANT = {"decode_step_ms_p50": 2.25, "decode_dispatch_ms_p50": 1.45,
        "prefill_us_per_tok": 2.2e3 / 132, "idle_dispatch_share": 7.0,
        "idle_engine_share": 18.0, "device_idle_share": 35.0}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    yield from bench_tiny.one_thread()


def _read(name, m):
    return spec.reader(name)(m)


def _recording(shift_ns: int = 0) -> trace.Recording:
    rec = trace.Recording()
    rec.anchor_perf_ns, rec.anchor_epoch_ns = ANCHOR_PERF, ANCHOR_EPOCH + shift_ns
    for i, (name, a, b, attrs) in enumerate(SPANS):
        sp = trace.Span(i, name, -1, dict(attrs))
        sp.start, sp.end = round(a * MS), round(b * MS)
        rec.spans.append(sp)
    return rec


def _measured(rec, *, with_trace=True, shift_ns: int = 0, open_s=1e-3, close_s=11e-3):
    """A measured run whose device operations sit on the epoch clock,
    ``shift_ns`` later than the anchor of ``_recording()`` puts them."""
    run = types.SimpleNamespace(open=open_s, close=close_s, window_s=close_s - open_s)
    tr = None
    if with_trace:
        start = [round(a * MS) - ANCHOR_PERF + ANCHOR_EPOCH + shift_ns for a, _ in OPS]
        dur = [round((b - a) * MS) for a, b in OPS]
        tr = Trace([f"op{i}" for i in range(len(OPS))], start, dur, run.window_s)
    return types.SimpleNamespace(run=run, trace=tr, model={}, mix={})


@pytest.fixture
def recorded(monkeypatch):
    def use(rec):
        monkeypatch.setattr(trace, "_rec", rec)
    return use


def test_hand_worked_window(recorded):
    recorded(_recording())
    m = _measured(trace.recording())
    got = {n: _read(n, m) for n in READERS}
    assert got == pytest.approx(WANT, rel=1e-9, abs=1e-9)
    assert got["idle_dispatch_share"] + got["idle_engine_share"] <= got["device_idle_share"]
    split = spans.idle_split(spans.read(m), m.trace)
    assert split == {"dispatch": round(0.7 * MS), "engine": round(1.8 * MS),
                     "sync": round(0.5 * MS), "outside": round(0.5 * MS)}
    # the four parts are the idle time that device_idle_share reads
    assert sum(split.values()) == round(3.5 * MS)
    # every sync span ends on an idle device as the anchor puts it
    assert spans.clock_fit(spans.read(m), m.trace)[1].tolist() == [0]


@pytest.mark.parametrize("shift_ms", [0.03, -40.0, 5e6])
def test_the_anchor_puts_the_spans_on_the_devices_clock(recorded, shift_ms):
    shift = round(shift_ms * MS)
    # the device's clock runs ``shift`` ahead of where the anchor says: read
    # with that anchor, nothing changes
    recorded(_recording(shift))
    m = _measured(trace.recording(), shift_ns=shift)
    assert {n: _read(n, m) for n in READERS} == pytest.approx(WANT, rel=1e-9, abs=1e-9)
    # read with the stale anchor, the spans land ``shift`` early on the
    # device's time line: the last decode step's sync then ends inside the
    # operation it waited for.  Within FIT_NS, the fit moves them back;
    # beyond it, the idle split moves; the host-clock readers never do.
    recorded(_recording())
    got = {n: _read(n, m) for n in READERS}
    fit = spans.clock_fit(spans.read(m), m.trace)
    if abs(shift) <= spans.FIT_NS:
        assert fit[1].tolist() == [shift]
        assert got == pytest.approx(WANT, rel=1e-9, abs=1e-9)
    else:
        assert got["idle_dispatch_share"] != pytest.approx(WANT["idle_dispatch_share"])
    assert got["decode_step_ms_p50"] == pytest.approx(WANT["decode_step_ms_p50"])


def test_the_clock_fit_follows_a_drifting_device_clock(recorded):
    """64 waits, each on a 100 us operation, the next operation 1 ms on:
    the first 32 end 30 us before their operation as the anchor puts them
    (the device's stamps run late early in a profile), the last 32 end 5 us
    after it.  The fit corrects the first piece alone, and then every wait
    ends on an idle device."""
    us = 1_000
    t0 = 2 * MS
    rec = trace.Recording()
    rec.anchor_perf_ns, rec.anchor_epoch_ns = 0, ANCHOR_EPOCH
    ops = []
    for k in range(64):
        t = t0 + k * MS
        ops.append((t, 100 * us))
        sp = trace.Span(k, "sync", -1, {"site": "h2d"})
        sp.start, sp.end = t + 50 * us, t + (70 if k < 32 else 105) * us
        rec.spans.append(sp)
    recorded(rec)
    run = types.SimpleNamespace(open=1e-3, close=70e-3, window_s=69e-3)
    tr = Trace(["op"] * 64, [ANCHOR_EPOCH + a for a, _ in ops], [d for _, d in ops],
               run.window_s)
    sp = spans.read(types.SimpleNamespace(run=run, trace=tr))
    fit = spans.clock_fit(sp, tr)
    assert fit[1].tolist() == [30 * us, 0]
    bs, be = spans.union(tr.start, tr.start + tr.dur)
    assert spans._covers(rec.to_epoch(sp.end), bs, be).sum() == 32
    assert not spans._covers(spans.on_device(sp, fit, sp.end), bs, be).any()


def test_spans_straddling_an_edge_are_not_counted(recorded):
    recorded(_recording())
    sp = spans.read(_measured(trace.recording()))
    assert list(sp.lengths("step.decode")) == [3 * MS, round(1.5 * MS)]
    assert sp.total("tokens", "engine.admit", "engine.chunk") == 132
    assert sorted(sp.self_times("step.decode")) == [1 * MS, round(1.9 * MS)]
    # a window that starts later drops the first tick and the admission's
    # tick straddles the new open: one decode step, no admission but the chunk
    m = _measured(trace.recording(), open_s=6.6e-3)
    assert _read("decode_step_ms_p50", m) == pytest.approx(1.5)
    assert _read("prefill_us_per_tok", m) == pytest.approx(0.2e3 / 32)


def test_no_trace_or_no_spans_reads_none(recorded, monkeypatch):
    recorded(_recording())
    m = _measured(trace.recording(), with_trace=False)
    got = {n: _read(n, m) for n in READERS}
    assert got["idle_dispatch_share"] is None and got["idle_engine_share"] is None
    assert got["decode_step_ms_p50"] == pytest.approx(2.25)
    # a window after every span: nothing to read
    m = _measured(trace.recording(), open_s=20e-3, close_s=30e-3)
    assert all(_read(n, m) is None for n in READERS[:5])
    # no recording yet, and a program without the recorder (the module
    # cannot be imported), read None and do not raise
    recorded(None)
    assert all(_read(n, _measured(None)) is None for n in READERS[:5])
    recorded(_recording())
    import repro_torch.runtime
    monkeypatch.delattr(repro_torch.runtime, "trace")
    monkeypatch.setitem(sys.modules, "repro_torch.runtime.trace", None)
    assert all(_read(n, _measured(None)) is None for n in READERS[:5])


def test_decode_steps_without_a_sync_and_a_window_without_steps(recorded):
    rec = _recording()
    rec.spans = [s for s in rec.spans if s.name not in ("step.decode", "step.prefill")]
    recorded(rec)
    m = _measured(rec)
    assert _read("decode_step_ms_p50", m) is None
    assert _read("decode_dispatch_ms_p50", m) is None
    # with no step, idle inside a tick and out of a sync is the engine's
    assert _read("idle_dispatch_share", m) == 0.0
    assert _read("idle_engine_share", m) == pytest.approx(18.0 + 7.0)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return bench_tiny.make_root(tmp_path_factory.mktemp("tiny"))


@pytest.mark.parametrize("cell", ["t.aligned", "t.paged"])
def test_a_profiled_tiny_run_reads_the_host_clock_metrics(root, cell):
    """A served window under a CPU profiler: the spans exist, the device
    trace holds no CUDA operation, so the three readers on the host's clock
    read and the two idle shares do not."""
    with profile(activities=[ProfilerActivity.CPU]):    # a first start is slow
        pass
    prof = profile(activities=[ProfilerActivity.CPU])
    _, cfg, mix, _, _, run, _, _ = harness.serve_cell(cell, 2 ** 31 + 5, 1.0, root=root,
                                                      device="cpu", prof=prof)
    m = harness.Measured(run, Trace.from_profiler(prof, run.window_s), cfg["model"], mix)
    got = {n: _read(n, m) for n in READERS[:5]}
    assert got["idle_dispatch_share"] is None and got["idle_engine_share"] is None
    assert 0 < got["decode_dispatch_ms_p50"] <= got["decode_step_ms_p50"]
    assert got["prefill_us_per_tok"] > 0
    sp = spans.read(m)
    assert sp.of("engine.tick").sum() > 0 and (sp.start >= round(run.open * 1e9)).all()
    assert np.isin(sp.name, ["engine.chunk" if mix["engine"]["paged"] else "engine.admit"]).any()
