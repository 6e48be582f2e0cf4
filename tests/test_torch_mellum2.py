"""Mellum2's layers in the port, on the CPU at a small size with seeded
random weights and the real period: three sliding-window layers to one full
layer, window 16, 8 experts top-2, YaRN on the full layer with
``original_max_position_embeddings`` 32.

The served logits are held to the configuration's plain reference,
``bench/models/mellum2.py``, which imports only torch.  Tolerances: the
model computes in float32 here and the scheduler keeps K/V in bf16, so a
position's logit error (RMS of the difference over the reference's
standard deviation) reads 0.002-0.004 at the 75th percentile; a router
whose top two flip on that rounding moves a few positions further (up to
0.04), so the check is on the 75th percentile, under 0.02.  The same
weights under an all-full or a no-YaRN reference read 0.19 and more.
"""
import collections
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import configs
from repro_torch.config import ModelConfig, MoEConfig, YarnConfig
from repro_torch.core.mesh import AbstractMesh
from repro_torch.launch import dryrun, specs
from repro_torch.launch.scheduler import Request, Scheduler
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.moe import MeshCtx
from repro_torch.parallel import steps as S
from repro_torch.runtime import trace

REPO = Path(__file__).resolve().parents[1]
WINDOW = 16
YARN = {"factor": 16.0, "original_max_position_embeddings": 32, "beta_fast": 32.0,
        "beta_slow": 1.0, "attention_factor": 1.2772588722239782}
MODEL = {"name": "tinymellum", "family": "moe", "n_layers": 4, "d_model": 64, "n_heads": 8,
         "n_kv_heads": 2, "head_dim": 32, "d_ff": 128, "vocab": 256,
         "block_pattern": ["attn_moe"], "rope_theta": 1000.0,
         "layer_windows": [WINDOW, WINDOW, WINDOW, None], "yarn": YARN, "norm_eps": 1e-6,
         "dtype": "float32", "moe": {"n_experts": 8, "top_k": 2, "d_ff_expert": 32}}
# (prompt, answer): prompts shorter and longer than the window, answers that
# carry the decode past the ring's wrap
SPEC = [(5, 14), (13, 9), (21, 8), (30, 12), (40, 6), (17, 10), (9, 20)]
TOL = 0.02


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF = _load("mellum2_reference", REPO / "bench" / "models" / "mellum2.py")


def _cfg(model=MODEL) -> ModelConfig:
    return ModelConfig(**dict(model, block_pattern=tuple(model["block_pattern"]),
                              moe=MoEConfig(**model["moe"])))


def _params(model=MODEL, seed=7):
    """The reference's weight tree (``leaf_plan``), f32 matrices, norm
    scales 1 + 0.1 z so that a scale skipped shows."""
    gen = torch.Generator().manual_seed(seed)
    params = {"layers": [{} for _ in range(model["n_layers"])]}
    for path, shape, kind, std in REF.leaf_plan(model):
        z = torch.randn(shape, generator=gen)
        leaf = 1 + 0.1 * z if std == 0.0 else z * std
        node = params
        for key in path[:-1]:
            node = node[key] if isinstance(key, int) else node.setdefault(key, {})
        node[path[-1]] = leaf
    return params


class _Recorded(Scheduler):
    """The scheduler with its steps' logits kept: the decode step returns
    its greedy tokens as before, from logits it keeps; each admission's
    slot and the steps before it are noted."""

    def __init__(self, cfg, params, **kw):
        super().__init__(cfg, params, **kw)
        self.steps, self.firsts, self.admits = [], [], {}
        decode, prefill = S.make_decode_step(cfg, return_logits=True), self._prefill

        def dec(params, tok, cache, pos):
            logits, cache = decode(params, tok, cache, pos)
            self.steps.append(logits)
            return torch.argmax(logits, dim=-1).to(torch.int32), cache

        def pre(params, batch, cache):
            logits, cache = prefill(params, batch, cache)
            self.firsts.append(logits[0])
            return logits, cache

        self._decode, self._prefill = dec, pre

    def _admit(self, req, slot):
        self.admits[req.rid] = (slot, len(self.steps), len(self.firsts))
        return super()._admit(req, slot)

    def logits_of(self, rid: int, n: int) -> torch.Tensor:
        """The logits that chose request ``rid``'s ``n`` tokens: its
        prefill's, then its slot's row of the decode steps after it."""
        slot, step, first = self.admits[rid]
        return torch.stack([self.firsts[first]] +
                           [self.steps[step + j][slot] for j in range(n - 1)])


def _err(x, ref):
    return (x - ref).pow(2).mean(-1).sqrt() / ref.std(-1)


@pytest.fixture(scope="module", params=[8, 32], ids=["bucket8", "bucket32"])
def served(request):
    """Served with bucket 8 (prompts past the window in buckets past it) and
    32 (short prompts in a bucket past the window too)."""
    cfg, params = _cfg(), _params()
    rng = np.random.RandomState(0)
    reqs = [Request(rid=i, prompt=rng.randint(0, MODEL["vocab"], lp).astype(np.int32), gen=g)
            for i, (lp, g) in enumerate(SPEC)]
    sched = _Recorded(cfg, params, slots=3, max_len=64, bucket=request.param)
    out = sched.run(reqs)
    return params, reqs, sched, out["completions"]


def _errors(served, model):
    params, reqs, sched, done = served
    errs = []
    for r in reqs:
        toks = done[r.rid].tokens
        prog = sched.logits_of(r.rid, len(toks))
        assert torch.equal(prog.argmax(-1), torch.tensor(toks))
        seq = torch.from_numpy(np.concatenate([r.prompt, toks[:-1]]).astype(np.int64))
        errs.append(_err(prog, REF.logits(params, model, seq, len(toks))))
    return torch.cat(errs)


def test_served_logits_match_the_reference_past_the_rings_wrap(served):
    e = _errors(served, MODEL)
    assert e.numel() == sum(g for _, g in SPEC)
    assert torch.quantile(e, 0.75) < TOL
    # the decode crossed the ring's wrap: positions past the window served
    assert max(lp + g for lp, g in SPEC) > 2 * WINDOW


@pytest.mark.parametrize("variant", ["all_full", "no_yarn"])
def test_an_all_full_or_no_yarn_reference_fails_the_comparison(served, variant):
    model = (dict(MODEL, layer_windows=[None] * 4) if variant == "all_full"
             else dict(MODEL, yarn=None))
    assert torch.quantile(_errors(served, model), 0.75) > 5 * TOL


def test_yarn_tables_follow_the_formula():
    """Mellum2's numbers: d 128, base 500,000, factor 16 over 8,192
    positions, beta 32 / 1: the ramp runs from pair 18 to 35."""
    y = YarnConfig(16.0, 8192, 32.0, 1.0, 1.2772588722239782)
    d, b = 128, 500000.0
    lo = np.floor(d * np.log(8192 / (32 * 2 * np.pi)) / (2 * np.log(b)))
    hi = np.ceil(d * np.log(8192 / (1 * 2 * np.pi)) / (2 * np.log(b)))
    assert (lo, hi) == (18, 35)
    i = np.arange(d // 2)
    r = 1 - np.clip((i - lo) / (hi - lo), 0, 1)
    base = b ** (-2 * i / d)
    want = (1 - r) * base / 16 + r * base
    got = np.array(L.yarn_inv_freq(b, d, y))
    np.testing.assert_allclose(got, want, rtol=1e-13)
    np.testing.assert_allclose(got, REF.inv_freq(d, b, {"factor": 16.0,
                               "original_max_position_embeddings": 8192, "beta_fast": 32.0,
                               "beta_slow": 1.0}).numpy(), rtol=1e-13)
    assert got[0] == 1.0 and got[18] == base[18] and got[35] == base[35] / 16
    # rope: the table's angles, cos and sin scaled by the attention factor
    cfg = _cfg(dict(MODEL, head_dim=128, rope_theta=b)).replace(yarn=y)
    x = torch.randn(1, 5, 2, 128, generator=torch.Generator().manual_seed(1))
    pos = torch.arange(100, 105)
    ang = pos.double()[:, None] * torch.from_numpy(got)
    cos, sin = (f(ang).float()[None, :, None] * y.attention_factor for f in (torch.cos, torch.sin))
    x1, x2 = x[..., :64], x[..., 64:]
    torch.testing.assert_close(L.rope(x, pos, cfg),
                               torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1),
                               rtol=0, atol=2e-4)      # f32 angles of positions ~100


def test_configs_without_per_layer_windows_run_as_before():
    cfg = configs.get("mixtral-8x22b")
    assert cfg.layer_windows is None and cfg.yarn is None
    assert all(cfg.layer_config(i) is cfg for i in range(cfg.n_layers))
    assert [cfg.layer_config(i).window for i in range(3)] == [cfg.window] * 3
    mine = _cfg()
    assert [mine.layer_config(i).window for i in range(8)] == [WINDOW] * 3 + [None] + \
        [WINDOW] * 3 + [None]
    assert [mine.layer_config(i).yarn is not None for i in range(4)] == [False] * 3 + [True]


def test_config_takes_a_files_lists_and_refuses_two_windows():
    cfg = _cfg()
    assert cfg.layer_windows == (WINDOW, WINDOW, WINDOW, None)
    assert cfg.yarn == YarnConfig(**YARN)
    assert hash(cfg) == hash(_cfg())
    with pytest.raises(ValueError, match="window or layer_windows"):
        cfg.replace(window=WINDOW)
    with pytest.raises(ValueError, match="yarn"):
        configs.get("mixtral-8x22b").replace(yarn=YARN)


@pytest.mark.parametrize("max_len", [64, 9])
def test_init_cache_gives_each_layer_its_ring_or_rows(max_len):
    cache = T.init_cache(_cfg(), 3, max_len, device="cpu")
    ring = min(max_len, WINDOW)
    assert [tuple(k.shape) for k, _ in cache] == [(3, ring, 2, 32)] * 3 + [(3, max_len, 2, 32)]
    assert all(k.dtype == v.dtype == torch.bfloat16 for k, v in cache)


def test_scheduler_takes_max_len_past_the_window_only_with_per_layer_windows():
    cfg = _cfg()
    sched = Scheduler(cfg, _params(), slots=2, max_len=4 * WINDOW)
    assert [k.shape[1] for k, _ in sched.cache] == [WINDOW] * 3 + [4 * WINDOW]
    mixtral = configs.reduced(configs.get("mixtral-8x22b"))
    with pytest.raises(NotImplementedError, match="attention window"):
        Scheduler(mixtral, {}, slots=2, max_len=mixtral.window + 1)


def test_paged_and_mesh_paths_refuse_per_layer_windows():
    cfg = _cfg()
    assert not T.supports_paged(cfg)
    with pytest.raises(NotImplementedError, match="layer_windows"):
        Scheduler(cfg, _params(), slots=2, max_len=32, paged=True)
    with pytest.raises(NotImplementedError, match="layer_windows"):
        T.init_paged_cache(cfg, 8, 4, device="cpu")
    ctx = MeshCtx(AbstractMesh((1, 2), ("data", "model")))
    with pytest.raises(NotImplementedError, match="layer_windows"):
        specs.cache_specs(cfg, ctx, T.init_cache(cfg, 2, 32, device="meta"))
    with pytest.raises(NotImplementedError, match="layer_windows"):
        T.init_cache(cfg, 2, 32, device="cpu", ctx=ctx)
    with pytest.raises(NotImplementedError, match="layer_windows"):
        dryrun.prepare_cell("mixtral-8x22b", "decode_32k", dryrun.recording_mesh(),
                            cfg_override=cfg)


def test_moe_spans_and_no_new_sync_site():
    cfg, params = _cfg(), _params()
    rng = np.random.RandomState(3)
    spec = [(5, 3), (20, 4), (9, 2)]
    reqs = [Request(rid=i, prompt=rng.randint(0, MODEL["vocab"], lp).astype(np.int32), gen=g)
            for i, (lp, g) in enumerate(spec)]
    sched = Scheduler(cfg, params, slots=2, max_len=32, bucket=8)
    assert trace.span("engine.tick") is trace._OFF
    with profile(activities=[ProfilerActivity.CPU]):
        out = sched.run(reqs)
    spans = trace.recording().spans
    by_id = {s.id: s for s in spans}
    count = collections.Counter(s.name for s in spans)
    sites = collections.Counter(s.attrs["site"] for s in spans if s.name == "sync")
    calls = MODEL["n_layers"] * (out["decode_steps"] + out["prefills"])
    assert count["moe.ffn"] == count["moe.experts"] == calls
    # the syncs are the dense model's and, only while a profile records, one
    # group-size read and one wait for the products a layer a call
    assert sites == {"decode": out["decode_steps"], "first_token": out["prefills"],
                     "h2d": 2 * (out["decode_steps"] + out["prefills"]), "moe_sizes": calls,
                     "moe_experts": calls}
    k = MODEL["moe"]["top_k"]
    tokens = sorted({s.attrs["rows"] for s in spans if s.name == "moe.ffn"})
    assert tokens == sorted({2} | {-(-lp // 8) * 8 for lp, _ in spec})   # slots, buckets
    for s in spans:
        if s.name == "moe.experts":
            ffn = by_id[s.parent]
            assert ffn.name == "moe.ffn" and s.attrs["rows"] == k * ffn.attrs["rows"]
            assert 1 <= s.attrs["experts"] <= min(MODEL["moe"]["n_experts"], s.attrs["rows"])
        if s.name == "sync" and s.attrs["site"] == "moe_sizes":
            assert by_id[s.parent].name == "moe.ffn"
        if s.name == "sync" and s.attrs["site"] == "moe_experts":
            assert by_id[s.parent].name == "moe.experts"
