"""The window arithmetic on synthetic token streams: whole-window rates,
tails over all samples, censored TTFT, closed-loop send times and tick
grouping."""
import numpy as np
import pytest

import bench_tiny  # noqa: F401  (puts the repository on sys.path)
from bench import records


class Clock:
    def __init__(self):
        self.now = 0.0

    def __call__(self):
        return self.now


def play(rec, clock, events):
    """Feeds (time, rid) events; returns True if the window closed."""
    for t, rid in events:
        clock.now = t
        try:
            rec.on_token(rid, 7)
        except records.WindowClosed:
            return True
    return False


def test_window_opens_after_warm_completions_and_closes_at_seconds():
    clock = Clock()
    rec = records.Recorder([2, 2, 3, 1], warm=1, seconds=1.0, clock=clock)
    closed = play(rec, clock, [(0.1, 0), (0.2, 1), (0.3, 0), (0.5, 1), (0.9, 2), (1.2, 2),
                               (1.29, 3), (1.3, 2), (1.4, 9)])
    assert closed
    assert rec.open == 0.3 and rec.close == pytest.approx(1.3)
    # the token at the close is neither recorded nor served
    assert rec.tokens[2] == [7, 7] and rec.done == [0, 1, 3]


def test_rates_and_tails_are_over_the_whole_window():
    clock = Clock()
    gens = [1] + [100] * 2
    rec = records.Recorder(gens, warm=1, seconds=2.0, clock=clock)
    ev = [(0.5, 0)]
    ev += [(0.5 + 0.01 * i, 1) for i in range(1, 100)]   # 99 tokens 10 ms apart
    ev += [(1.0 + 0.1 * i, 2) for i in range(1, 15)]     # 14 tokens 100 ms apart
    ev += [(2.6, 2)]                                      # past the close at 2.5
    assert play(rec, clock, ev)
    run = records.Run(rec, [5, 5, 5], slots=3)
    assert run.window_s == pytest.approx(2.0)
    assert run.out_tokens() == 1 + 99 + 14
    itl = run.itl_s()
    assert len(itl) == 98 + 13
    # the tail of all gaps, not of a median a chunk: 13 of 111 gaps are 100 ms
    assert records.percentile(itl, 95) == pytest.approx(0.1)
    assert records.percentile([], 95) is None


def test_closed_loop_send_times_and_censored_ttft():
    clock = Clock()
    # 2 slots: requests 0 and 1 sent at the start, 2 at 0's finish, 3 at 1's
    gens = [2, 3, 2, 5, 1]
    rec = records.Recorder(gens, warm=1, seconds=1.0, clock=clock)
    clock.now = -1.0
    rec.start = -1.0
    ev = [(0.0, 0), (0.1, 1), (0.2, 0),       # 0 done at 0.2: window opens, 2 sent
          (0.3, 1), (0.4, 2), (0.5, 1),       # 1 done at 0.5: 3 sent
          (0.7, 2),                           # 2 done at 0.7: 4 sent, no first token
          (1.25, 9)]                          # past the close at 1.2
    assert play(rec, clock, ev)
    run = records.Run(rec, [4] * 5, slots=2)
    assert run.sent.tolist() == [-1.0, -1.0, 0.2, 0.5, 0.7]
    assert sorted(run.attempted().tolist()) == [2, 3, 4]
    # 2: 0.4 - 0.2; 3 and 4 never got a first token: close - sent
    np.testing.assert_allclose(run.ttft_s(), [0.2, 0.7, 0.5])
    # the token that opens the window lies inside it
    assert run.finished().tolist() == [0, 1, 2]


def test_ticks_group_bursts_and_mark_prefill_ticks():
    clock = Clock()
    gens = [50, 50, 3, 50]
    rec = records.Recorder(gens, warm=0, seconds=10.0, clock=clock)
    rec.open, rec.close = 0.0, 10.0
    rec.start = -1.0
    ev = []
    t = 0.0
    for tick in range(6):
        t += 0.05 if tick != 3 else 0.12
        if tick == 0:
            ev += [(t - 0.03, 0), (t - 0.02, 1), (t - 0.01, 2)]   # first tokens, apart
        ev += [(t, 0), (t + 1e-5, 1)]
        if tick < 2:
            ev += [(t + 2e-5, 2)]
    # request 2 finishes in tick 1's burst: request 3 is sent then, admitted in
    # tick 2 and, with a 40-token prompt in chunks of 16, prefills in ticks 2-4
    assert not play(rec, clock, ev)
    run = records.Run(rec, [4, 4, 4, 40], slots=3, chunk=16)
    b = run.decode_bursts()
    assert len(b) == 6
    walls, carried = run.ticks()
    np.testing.assert_allclose(walls, [0.05, 0.05, 0.12, 0.05, 0.05])
    assert carried.tolist() == [False, True, True, True, False]


def test_kv_live_tokens_average_the_contexts_in_flight():
    clock = Clock()
    # 0 finishes inside the window; 1 is still in flight at the close
    rec = records.Recorder([2, 3], warm=0, seconds=1.0, clock=clock)
    rec.open, rec.close = 0.0, 1.0
    assert not play(rec, clock, [(-0.5, 0), (0.4, 0), (0.5, 1), (0.8, 1)])
    run = records.Run(rec, [10, 20], slots=2)
    # 0: 11 tokens held from the window's open to its last token at 0.4;
    # 1: 21 from 0.5 to 0.8, then 22 to the close
    assert run.kv_live_tokens() == pytest.approx(11 * 0.4 + 21 * 0.3 + 22 * 0.2)
