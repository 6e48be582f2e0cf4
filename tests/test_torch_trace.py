"""The port's span recorder (``runtime/trace.py``) and the spans that the
serving engine and the model step report through it, on the CPU.

Spans are kept exactly while a ``torch.profiler`` profile records; served
runs of tiny models under a CPU profiler must record one ``engine.tick``
per tick, one ``step.decode`` per decode step, one ``engine.admit`` per
non-empty end-aligned admission, one ``engine.chunk`` per paged prefill
chunk, and a ``sync`` span at every place the host waits for the device,
counted by site, all against the counts ``Scheduler.run`` returns.
"""
import collections
import math
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import configs
from repro_torch.launch.scheduler import Request, Scheduler
from repro_torch.models import transformer as T
from repro_torch.runtime import trace


def _profiled():
    """A CPU profile.  A span asked for first finds the profiler off,
    so the profile's spans start a new recording."""
    assert trace.span("engine.tick") is trace._OFF
    return profile(activities=[ProfilerActivity.CPU])


# ---- the recorder ---------------------------------------------------------

def test_nothing_is_kept_without_a_profiler():
    before = trace.recording()
    n = len(before.spans) if before is not None else 0
    with trace.span("engine.tick", rows=3) as sp:
        sp.set(admits=1)
    assert trace.recording() is before
    assert (len(before.spans) if before is not None else 0) == n


def test_spans_are_recorded_under_a_profiler():
    with _profiled():
        with trace.span("engine.tick", rows=2) as sp:
            sp.set(admits=1)
        with trace.span("sync", site="decode"):
            pass
    rec = trace.recording()
    assert [s.name for s in rec.spans] == ["engine.tick", "sync"]
    tick, sync = rec.spans
    assert tick.attrs == {"rows": 2, "admits": 1} and sync.attrs == {"site": "decode"}
    assert 0 < tick.start <= tick.end <= sync.start <= sync.end
    assert tick.parent == sync.parent == -1 and tick.id != sync.id
    assert rec.open == []


def test_parents_and_a_span_cut_by_an_exception():
    with _profiled():
        with trace.span("engine.tick") as tick:
            with trace.span("step.decode") as step:
                with trace.span("sync", site="decode") as sync:
                    pass
            with pytest.raises(KeyError):
                with trace.span("engine.admit", tokens=4):
                    with trace.span("step.prefill"):
                        pass
                    raise KeyError("cut")
        with trace.span("sync", site="h2d") as after:
            pass
    rec = trace.recording()
    names = [s.name for s in rec.spans]
    # the admission that the exception cut is dropped; what ended before it
    # is kept, and the tick that caught the exception ends normally
    assert names == ["sync", "step.decode", "step.prefill", "engine.tick", "sync"]
    by_id = {s.id: s for s in rec.spans}
    assert sync.parent == step.id and step.parent == tick.id and tick.parent == -1
    prefill = rec.spans[2]
    assert prefill.parent not in by_id and prefill.parent != tick.id
    assert after.parent == -1
    assert len(by_id) == len(rec.spans)          # ids stay unique past a dropped span
    assert rec.open == []


def test_a_new_recording_starts_afresh():
    with _profiled():
        with trace.span("engine.tick"):
            pass
    first = trace.recording()
    with trace.span("engine.tick"):                # seen off: the profile ended
        pass
    with _profiled():
        with trace.span("step.decode"):
            pass
    second = trace.recording()
    assert second is not first
    assert [s.name for s in first.spans] == ["engine.tick"]
    assert [s.name for s in second.spans] == ["step.decode"]


def test_spans_begun_and_ended_across_a_profile_edge():
    prof = _profiled()
    prof.start()
    with trace.span("engine.tick"):
        prof.stop()
    rec = trace.recording()
    assert [s.name for s in rec.spans] == ["engine.tick"]      # it ended normally
    prof = _profiled()
    with trace.span("engine.tick"):                # off
        prof.start()
        with trace.span("step.decode"):
            pass
    prof.stop()
    assert [s.name for s in trace.recording().spans] == ["step.decode"]


def test_the_anchor_puts_spans_on_the_profilers_clock():
    x = torch.randn(256, 256)
    with _profiled() as prof:
        with trace.span("step.decode") as sp:
            for _ in range(20):
                x = torch.tanh(x @ x)
    rec = trace.recording()
    lo, hi = rec.to_epoch(sp.start), rec.to_epoch(sp.end)
    mm = [e for e in prof.profiler.kineto_results.events() if e.name() == "aten::mm"]
    assert len(mm) == 20
    slack = 2_000_000                              # 2 ms
    assert all(lo - slack <= e.start_ns() and e.start_ns() + e.duration_ns() <= hi + slack
               for e in mm)
    assert abs(rec.to_epoch(time.perf_counter_ns()) - time.time_ns()) < slack


# ---- the engine's spans ---------------------------------------------------

def _params(cfg, seed=0):
    return T.init(cfg, torch.Generator().manual_seed(seed))


def _mix(vocab, spec, seed=3):
    rng = np.random.RandomState(seed)
    return [Request(rid=i, prompt=rng.randint(0, vocab, (lp,)).astype(np.int32), gen=g)
            for i, (lp, g) in enumerate(spec)]


SPEC = [(5, 3), (9, 4), (0, 2), (12, 5), (3, 1), (7, 6)]


def _served(cfg, params, reqs, **kw):
    sched = Scheduler(cfg, params, slots=2, max_len=32, **kw)
    with _profiled():
        out = sched.run(reqs)
    spans = trace.recording().spans
    count = collections.Counter(s.name for s in spans)
    sites = collections.Counter(s.attrs["site"] for s in spans if s.name == "sync")
    return out, spans, count, sites


def _nested(spans):
    """Each step span's and admission's holder, by name."""
    by_id = {s.id: s for s in spans}
    return {(s.name, by_id[s.parent].name) for s in spans
            if s.name in ("step.decode", "step.prefill", "engine.admit", "engine.chunk")}


@pytest.fixture(scope="module")
def dense():
    cfg = configs.reduced(configs.get("llama3.2-3b")).replace(dtype="float32", vocab=64)
    return cfg, _params(cfg)


def test_end_aligned_run_records_its_ticks_steps_admissions_and_syncs(dense):
    cfg, params = dense
    reqs = _mix(cfg.vocab, SPEC)
    out, spans, count, sites = _served(cfg, params, reqs, bucket=4)
    steps, prefills = out["decode_steps"], out["prefills"]
    assert prefills == sum(lp > 0 for lp, _ in SPEC)
    assert count["engine.tick"] == out["ticks"]
    assert count["step.decode"] == steps
    assert count["engine.admit"] == count["step.prefill"] == prefills
    assert count["engine.chunk"] == 0
    # the decode step's tokens and each admission's first token; the tokens
    # and positions (and a prompt and its length) copied in from the host
    assert sites == {"decode": steps, "first_token": prefills,
                     "h2d": 2 * steps + 2 * prefills}
    assert _nested(spans) == {("step.decode", "engine.tick"), ("engine.admit", "engine.tick"),
                              ("step.prefill", "engine.admit")}
    admits = [s for s in spans if s.name == "engine.admit"]
    assert sorted(s.attrs["tokens"] for s in admits) == sorted(lp for lp, _ in SPEC if lp)
    ticks = [s for s in spans if s.name == "engine.tick"]
    assert sum(s.attrs["admits"] for s in ticks) == len(SPEC)
    assert all(s.attrs["chunks"] == 0 for s in ticks)
    by_id = {s.id: s for s in spans}
    for s in spans:
        if s.name == "step.decode":
            assert s.attrs["rows"] == by_id[s.parent].attrs["rows"] > 0


def test_paged_run_records_its_chunks_and_page_writes(dense):
    cfg, params = dense
    reqs = _mix(cfg.vocab, SPEC)
    chunk = 4
    out, spans, count, sites = _served(cfg, params, reqs, paged=True, block=4, chunk=chunk)
    steps = out["decode_steps"]
    chunks = sum(math.ceil(lp / chunk) for lp, _ in SPEC)
    firsts = sum(lp > 0 for lp, _ in SPEC)
    assert count["engine.tick"] == out["ticks"]
    assert count["step.decode"] == steps
    assert count["engine.chunk"] == count["step.prefill"] == chunks
    assert count["engine.admit"] == 0
    # a page write of K and one of V a layer, in each decode step and chunk
    assert sites == {"decode": steps, "first_token": firsts,
                     "h2d": 3 * steps + 2 * chunks,
                     "paged_write": 2 * cfg.n_layers * (steps + chunks)}
    assert _nested(spans) == {("step.decode", "engine.tick"), ("engine.chunk", "engine.tick"),
                              ("step.prefill", "engine.chunk")}
    assert sum(s.attrs["tokens"] for s in spans if s.name == "engine.chunk") == \
        sum(lp for lp, _ in SPEC)
    assert sum(s.attrs["chunks"] for s in spans if s.name == "engine.tick") == chunks


def test_moe_run_records_its_group_sizes_sync():
    cfg = configs.reduced(configs.get("mixtral-8x22b")).replace(dtype="float32", vocab=64)
    params = _params(cfg, 1)
    reqs = _mix(cfg.vocab, SPEC)
    out, spans, count, sites = _served(cfg, params, reqs, bucket=4)
    steps, prefills = out["decode_steps"], out["prefills"]
    moe_layers = sum(k.endswith("moe") for k in cfg.block_pattern)
    assert moe_layers >= 1
    assert count["step.decode"] == steps and count["engine.admit"] == prefills
    # one group-size read and one wait for the products a MoE layer a step,
    # both only while a profile records; one process takes every assignment
    # (the capacity's ``_kept`` is an expert-parallel read)
    assert sites == {"decode": steps, "first_token": prefills,
                     "h2d": 2 * steps + 2 * prefills,
                     "moe_sizes": moe_layers * (steps + prefills),
                     "moe_experts": moe_layers * (steps + prefills)}


def test_recurrent_admission_records_its_token_loop():
    cfg = configs.reduced(configs.get("xlstm-1.3b")).replace(
        dtype="float32", vocab=64, block_pattern=("mlstm", "slstm"), n_layers=2)
    params = _params(cfg, 2)
    spec = [(3, 2), (0, 2), (4, 3)]
    reqs = _mix(cfg.vocab, spec)
    out, spans, count, sites = _served(cfg, params, reqs)
    steps, prefills = out["decode_steps"], out["prefills"]
    assert count["engine.tick"] == out["ticks"] and count["step.decode"] == steps
    assert count["engine.admit"] == count["step.prefill"] == prefills == 2
    # the prompt goes through one-token steps, each token copied in
    assert sites == {"decode": steps, "first_token": prefills,
                     "h2d": 2 * steps + sum(lp for lp, _ in spec)}
