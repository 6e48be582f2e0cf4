"""The end-aligned engine's decode step replayed from one CUDA graph
(``launch/scheduler.py``: ``decode_graphed``).

On the card (tests marked ``card``; they skip without a CUDA device): the
same staggered requests through an eager engine and a graphed one, for a
ChatGLM3-like model (rep 16, hd 128, greedy and sampled), a Mellum2-like
one (window rings beside full rows, YaRN, routed experts through the
grouped kernels) and a Zamba2-like hybrid (a recurrent state that the step
returns anew).  The tokens and the logits tap's rows (``bench/tap.py``)
must be equal bit for bit, every decode step but the eager warm-up must be
a replay, and a second run after ``reset`` must capture anew and serve the
same.  Run them there with ``python -m pytest -q -m card
tests/test_torch_decode_graph.py``.

On the CPU: the rule that picks the graph, and the CPU engine's tokens,
which it serves eagerly with no replay.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import configs
from repro_torch.config import ModelConfig, MoEConfig, YarnConfig
from repro_torch.core.mesh import AbstractMesh
from repro_torch.launch import scheduler
from repro_torch.launch.scheduler import Request, Scheduler, decode_graphed
from repro_torch.models import transformer as T
from repro_torch.models.moe import MeshCtx
from repro_torch.parallel import steps as S
from repro_torch.runtime import trace
from repro_torch.tree import leaves

REPO = Path(__file__).resolve().parents[1]
MAX_LEN = 64
# (prompt, answer, arrival tick): staggered, an empty prompt, more requests
# than slots so slots are reused, prompts past a window of 16
SPEC = [(5, 14, 0), (13, 9, 0), (30, 8, 1), (0, 6, 2), (21, 12, 4), (9, 20, 7), (40, 6, 9)]
SLOTS = 3


def _tap_module():
    spec = importlib.util.spec_from_file_location("bench_tap", REPO / "bench" / "tap.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _requests(vocab: int, seed: int = 0):
    rng = np.random.RandomState(seed)
    return [Request(rid=i, prompt=rng.randint(0, vocab, lp).astype(np.int32), gen=g,
                    arrival=a) for i, (lp, g, a) in enumerate(SPEC)]


# ---- the rule -------------------------------------------------------------

@pytest.mark.parametrize("device", ["cuda", "cpu"])
@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("ranked", [False, True])
def test_the_graph_is_taken_on_the_card_unpaged_in_one_process(device, paged, ranked):
    ctx = MeshCtx(AbstractMesh((1, 2), ("data", "model"))) if ranked else None
    want = device == "cuda" and not paged and not ranked
    assert decode_graphed(torch.device(device), paged, ctx) is want


def _tiny_dense():
    cfg = configs.reduced(configs.get("llama3.2-3b")).replace(dtype="float32", vocab=64)
    return cfg, T.init(cfg, torch.Generator().manual_seed(0))


def _one_at_a_time(cfg, params, req: Request, bucket: int):
    """Greedy tokens of one request alone: a fused prefill of its bucket
    into a one-row cache, then one decode step a token."""
    cache = T.init_cache(cfg, 1, MAX_LEN, device="cpu")
    lp = len(req.prompt)
    lb = -(-lp // bucket) * bucket
    toks = np.zeros((1, lb), np.int32)
    toks[0, :lp] = req.prompt
    logits, cache = S.make_prefill_step(cfg)(
        params, {"tokens": torch.from_numpy(toks), "length": torch.tensor([lp], dtype=torch.int32)},
        cache)
    out = [int(torch.argmax(logits[0]))]
    decode = S.make_decode_step(cfg)
    while len(out) < req.gen:
        tok, cache = decode(params, torch.tensor([out[-1]], dtype=torch.int32), cache,
                            torch.tensor([lp + len(out) - 1], dtype=torch.int32))
        out.append(int(tok[0]))
    return out


@pytest.mark.parametrize("paged", [False, True], ids=["aligned", "paged"])
def test_the_cpu_engine_serves_eagerly_with_no_replay(paged):
    cfg, params = _tiny_dense()
    reqs = [r for r in _requests(cfg.vocab) if len(r.prompt)]
    kw = dict(paged=True, block=4, chunk=8) if paged else dict(bucket=4)
    sched = Scheduler(cfg, params, slots=SLOTS, max_len=MAX_LEN, **kw)
    assert not sched._graphed
    assert isinstance(sched._tok, np.ndarray) and isinstance(sched._pos, np.ndarray)
    # a span asked for with the profiler off makes the profile's spans a
    # recording of their own
    assert trace.span("engine.tick") is trace._OFF
    with profile(activities=[ProfilerActivity.CPU]):
        out = sched.run(reqs)
    steps = [s for s in trace.recording().spans if s.name == "step.decode"]
    assert len(steps) == out["decode_steps"] > 0
    assert all(s.attrs["graph"] == 0 for s in steps)
    assert out["decode_replays"] == 0
    for r in reqs:
        assert out["completions"][r.rid].tokens == _one_at_a_time(cfg, params, r, 4), r.rid


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["llama3.2-3b", "zamba2-1.2b", "xlstm-1.3b"])
def test_the_graph_step_reads_and_writes_the_engines_own_leaves(arch, dtype):
    """The step the graph captures, run eagerly: after the warm-up, which
    takes the leaves the step returns, the engine's cache leaves stay its
    own (a capture bakes their addresses in), K/V written in place and a
    state the step returns anew copied into them, equal to the eager
    engine's step after step."""
    cfg = configs.reduced(configs.get(arch)).replace(dtype=dtype, vocab=64)
    params = T.init(cfg, torch.Generator().manual_seed(0))
    eager = Scheduler(cfg, params, slots=2, max_len=16)
    graph = Scheduler(cfg, params, slots=2, max_len=16)
    tok, pos = torch.tensor([3, 7], dtype=torch.int32), torch.tensor([0, 5], dtype=torch.int32)
    own = None
    for _ in range(4):
        want, eager.cache = eager._decode(params, tok, eager.cache, pos)
        graph._dev_in = [tok, pos]
        got = graph._graph_step(adopt=own is None)
        own = own or leaves(graph.cache)
        assert torch.equal(got, want)
        assert all(a is b for a, b in zip(leaves(graph.cache), own))
        for a, b in zip(own, leaves(eager.cache)):
            assert a.dtype == b.dtype and torch.equal(a, b)
        tok, pos = want, pos + 1


# ---- on the card ----------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the graph is captured and replayed on the card")
    return torch.device("cuda")


def _glm():
    """ChatGLM3's attention shapes (32 / 2 heads of 128, half-dim RoPE) at
    two narrow layers."""
    return configs.get("chatglm3-6b").replace(n_layers=2, d_model=256, d_ff=512, vocab=512,
                                              head_dim=128)


def _mellum():
    """Mellum2's layout at a small width: three 16-token window layers to a
    full one with YaRN, 8 experts top-2, group 4."""
    yarn = YarnConfig(factor=16.0, original_max_position_embeddings=32, beta_fast=32.0,
                      beta_slow=1.0, attention_factor=1.2772588722239782)
    return ModelConfig(name="tinymellum", family="moe", n_layers=4, d_model=128, n_heads=8,
                       n_kv_heads=2, head_dim=32, d_ff=256, vocab=512,
                       block_pattern=("attn_moe",), rope_theta=1000.0,
                       layer_windows=(16, 16, 16, None), yarn=yarn, norm_eps=1e-6,
                       moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=64))


def _zamba():
    """Zamba2's period (Mamba2 layers, two shared-attention points) at the
    reduced width."""
    return configs.reduced(configs.get("zamba2-1.2b"))


MODELS = {"chatglm3": _glm, "mellum2": _mellum, "zamba2": _zamba}


def _serve(tap_mod, cfg, params, dev, reqs, *, graphed: bool, **kw):
    """Two runs of ``reqs`` with a ``reset`` between, through a logits tap
    of a row a position: (each run's output, its tokens, its tap rows).  An
    eager engine is built where the rule is made to refuse the graph."""
    tap = tap_mod.Tap(slots=SLOTS, rows=MAX_LEN, keep=1, vocab=cfg.vocab, device=dev)
    with pytest.MonkeyPatch.context() as mp, tap.installed():
        if not graphed:
            mp.setattr(scheduler, "decode_graphed", lambda *a: False)
        sched = Scheduler(cfg, params, slots=SLOTS, max_len=MAX_LEN, bucket=8, **kw)
    assert sched._graphed is graphed
    runs = []
    for _ in range(2):
        tap.ring.zero_()
        tap.ring_arg.zero_()
        out = sched.run(reqs)
        torch.cuda.synchronize()
        runs.append((out, {r: c.tokens for r, c in out["completions"].items()},
                     tap.ring.clone(), tap.ring_arg.clone()))
        sched.reset()
    return runs


@pytest.mark.card
@pytest.mark.parametrize("model,temperature", [("chatglm3", 0.0), ("chatglm3", 0.8),
                                               ("mellum2", 0.0), ("zamba2", 0.0)],
                         ids=["chatglm3", "chatglm3-sampled", "mellum2", "zamba2"])
def test_the_graphed_engine_serves_what_the_eager_one_does(card, model, temperature):
    tap_mod = _tap_module()
    cfg = MODELS[model]()
    params = T.init(cfg, torch.Generator(device=card).manual_seed(3), dtype=torch.bfloat16)
    reqs = _requests(cfg.vocab, seed=1)
    kw = dict(temperature=temperature, top_p=0.9, seed=5)
    eager = _serve(tap_mod, cfg, params, card, reqs, graphed=False, **kw)
    graph = _serve(tap_mod, cfg, params, card, reqs, graphed=True, **kw)
    for (eo, et, er, ea), (go, gt, gr, ga) in zip(eager, graph):
        assert eo["decode_replays"] == 0
        assert go["decode_steps"] == eo["decode_steps"] > 2
        assert go["decode_replays"] == go["decode_steps"] - 1
        assert gt == et
        if not temperature:            # the sampled step's logits skip the tap
            assert torch.equal(gr, er) and torch.equal(ga, ea)
            assert er.abs().sum() > 0
    assert graph[0][1] == graph[1][1] and torch.equal(graph[0][2], graph[1][2])
