"""Whole runs of tiny cells on the CPU (the look for a card skipped): a
sound program comes out correct and the float8 control fails a limit;
with the timed path broken underneath, ``correct`` comes out false, once
for each fault a serving cell can have on one chip.  (There is no exchange
between chips to leave out.)  The MoE cell is judged by the logits tap's
statistics alone."""
import pytest
import torch

import bench_tiny
from bench import check, harness, spec
from bench.tap import Tap

SECONDS = 0.6


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    yield from bench_tiny.one_thread()


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return bench_tiny.make_root(tmp_path_factory.mktemp("tiny"))


def _broken(make, fault):
    """A decode step factory (``parallel.steps.make_decode_step``, or the
    tap's) with ``fault`` planted in the step it makes."""
    def factory(cfg, **kw):
        step = make(cfg, **kw)
        calls = [0]

        def run(params, token, cache, pos, *rest):
            if fault == "half_batch":
                # the second half of the rows left out: they take the first
                # half's tokens
                h = token.shape[0] // 2
                if rest:
                    out, cache = step(params, token[:h], cache, pos[:h], rest[0][:h])
                else:
                    rows = [tuple(t[:h] for t in kv) for kv in cache]
                    out, _ = step(params, token[:h], rows, pos[:h])
                return torch.cat([out, out])[:token.shape[0]], cache
            saved = [tuple(t.clone() for t in kv) for kv in cache]
            out, cache = step(params, token, cache, pos, *rest)
            if fault == "state_unchanged":
                for kv, old in zip(cache, saved):
                    for t, o in zip(kv, old):
                        t.copy_(o)
            elif fault == "token_altered":
                # one row's token a step, each row in turn
                out = out.clone()
                row = calls[0] % out.shape[0]
                out[row] = (out[row] + 1) % cfg.vocab
                calls[0] += 1
            return out, cache
        return run
    return factory


@pytest.mark.parametrize("cell", ["t.paged", "t.aligned", "m.aligned"])
def test_sound_runs_are_correct(root, cell, monkeypatch):
    bench_tiny.token_clock(monkeypatch)
    res, lines = harness.run_cell(cell, 2 ** 31 + 11, SECONDS, False, root=root, device="cpu")
    assert res["correct"], lines
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(res["metrics"]) == {"out_tok_s", "ttft_p95_ms", "itl_p95_ms", "setup_s"}
    assert list(res)[-1] == "check"
    assert res["check"]["served_not_argmax"]["value"] == 0


@pytest.mark.parametrize("fault", ["token_altered", "state_unchanged", "half_batch"])
@pytest.mark.parametrize("cell", ["t.paged", "t.aligned", "m.aligned"])
def test_a_broken_timed_path_is_not_correct(root, cell, fault, monkeypatch):
    """A token is altered where it is produced, after the tap's argmax; the
    state and the batch are broken inside the step, under the tap."""
    from repro_torch.parallel import steps
    bench_tiny.token_clock(monkeypatch)
    if fault == "token_altered":
        wrap = Tap.wrap_decode
        monkeypatch.setattr(Tap, "wrap_decode", lambda tap, make: _broken(wrap(tap, make), fault))
    else:
        monkeypatch.setattr(steps, "make_decode_step", _broken(steps.make_decode_step, fault))
    res, lines = harness.run_cell(cell, 2 ** 31 + 12, SECONDS, False, root=root, device="cpu")
    assert not res["correct"], lines
    if fault == "token_altered":
        assert res["check"]["served_not_argmax"]["value"] > 0, lines


@pytest.mark.parametrize("cell", ["t.paged", "m.aligned"])
@pytest.mark.parametrize("seed", [5, 6])
def test_the_float8_control_fails_the_limit(root, cell, seed, monkeypatch):
    """The program holds every limit of its configuration and the control
    fails one; the MoE configuration names only the tap's statistics."""
    bench_tiny.token_clock(monkeypatch)
    sv = harness.serve_cell(cell, seed, SECONDS, root=root, device="cpu")
    cmp = check.compare(sv.run, sv.params, sv.cfg["model"], sv.prompts, seed, sv.mix["check"],
                        torch.device("cpu"), logits=sv.module.logits, tap=sv.tap, control=True)
    limits = sv.cfg["check"]
    if cell == "m.aligned":
        assert set(limits) == {"served_not_argmax", "logit_err_p75"}
    read = {name: spec.statistic(name, root) for name in limits}
    assert all(read[n](cmp["program"]) <= lim for n, lim in limits.items())
    assert any(read[n](cmp["control"]) > lim for n, lim in limits.items())


def test_per_layer_metrics_read_the_run(root):
    res, _ = harness.run_cell("t.paged", 17, SECONDS, True, root=root, device="cpu")
    # no profiler off the card: only the readers of the token records report
    # (a tick kind may find no tick in a short window on a busy machine)
    assert {"serve_mfu"} <= set(res["metrics"]) <= {"serve_mfu", "decode_tick_ms_p50",
                                                   "prefill_tick_ms_p50"}
    assert 0 < res["metrics"]["serve_mfu"]["value"] < 100
    assert all(m["value"] > 0 for m in res["metrics"].values())
