"""The logits tap on tiny CPU cells: the served tokens and the program's
waits for the device are the same with and without it, and it keeps the
rows of every request that the check's sample draws."""
import collections

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import bench_tiny
from bench import check, harness

SECONDS = 0.6
CELLS = ["t.paged", "t.aligned", "m.aligned"]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    yield from bench_tiny.one_thread()


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return bench_tiny.make_root(tmp_path_factory.mktemp("tiny"))


def _syncs(prof) -> collections.Counter:
    """The ``sync`` spans of the program's recording, by site."""
    from repro_torch.runtime import trace
    return collections.Counter(s.attrs.get("site") for s in trace.recording().spans
                               if s.name == "sync")


@pytest.mark.parametrize("cell", CELLS)
def test_served_tokens_and_syncs_are_the_same_without_the_tap(root, cell, monkeypatch):
    with profile(activities=[ProfilerActivity.CPU]):    # a first start is slow
        pass
    runs, syncs = [], []
    for tapped in (True, False):
        bench_tiny.token_clock(monkeypatch)             # each run's clock from 0
        prof = profile(activities=[ProfilerActivity.CPU])
        sv = harness.serve_cell(cell, 2 ** 31 + 21, SECONDS, root=root, device="cpu",
                                prof=prof, tapped=tapped)
        runs.append(sv.run)
        syncs.append(_syncs(prof))
    with_tap, without = runs
    assert with_tap.out_tokens() > 0
    assert with_tap.tokens == without.tokens
    assert (with_tap.t.size, with_tap.open, with_tap.close) == \
        (without.t.size, without.open, without.close)
    assert syncs[0] == syncs[1] and syncs[0]["decode"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_the_tap_keeps_every_request_the_sample_draws(root, cell, monkeypatch):
    bench_tiny.token_clock(monkeypatch)
    seed = 2 ** 31 + 22
    sv = harness.serve_cell(cell, seed, SECONDS, root=root, device="cpu")
    done = sv.run.finished()
    # every finished request is placed on its slot
    assert len(done) > 8 and sv.tap.placed[done].all()
    rids = check.sample(sv.run, seed, sv.mix["check"]["requests"], sv.tap.placed)
    assert rids == check.sample(sv.run, seed, sv.mix["check"]["requests"])
    assert set(rids) <= set(sv.tap.kept) and len(sv.tap.kept) <= sv.tap.keep
    # the kept argmax tokens are the tokens served, and lead their rows
    te = sv.mix["check"]["tokens_each"]
    for r in rids:
        served = sv.run.tokens[r]
        held, rows, arg = sv.tap.rows_for(r, len(served), min(te, len(served)))
        assert held.all()
        want = torch.as_tensor(served[-te:])
        assert torch.equal(arg, want)
        assert torch.equal(rows.gather(1, want[:, None])[:, 0], rows.max(-1).values)


def test_the_sample_takes_the_longest_then_the_seeds_ranks(root, monkeypatch):
    bench_tiny.token_clock(monkeypatch)
    sv = harness.serve_cell("t.aligned", 7, SECONDS, root=root, device="cpu", tapped=False)
    run, done = sv.run, sv.run.finished()
    rids = check.sample(run, 7, 5)
    total = run.prompt_lens + run.gens
    assert rids[0] in done and total[rids[0]] == total[done].max()
    order = check.ranks(7, len(run.gens))
    rest = [r for r in done if r != rids[0]]
    assert rids[1:] == sorted(rest, key=lambda r: order[r])[:4]
    assert sorted(order.tolist()) == list(range(len(run.gens)))
    assert not np.array_equal(order, check.ranks(8, len(run.gens)))
