"""The serve engine under a mesh ctx on gloo CPU ranks, against the JAX
package's single-device functions.

JAX's own paths under a ctx do not run on jax 0.9.0 (``layers.py _cstr`` on
an Explicit mesh), so every check holds the port on its ranks against JAX's
single-device function on the same numpy inputs.  JAX initialises the
tiny llama of the serving tests (reduced, vocab 64), ``repro_torch.convert``
carries the parameters over, and each rank keeps its blocks
(``shard_params``) and its cache blocks (``init_cache(ctx=)``, by
``cache_specs``: the cache length split over ``model``).  The serve steps
take the global rows and return the global logits on every rank.

  * end-aligned: a right-padded fused prefill (logits, and the cache
    reassembled by ``cache_specs``) and decode steps at per-row positions,
    f32 (1e-5) and a bf16 model (2e-2);
  * the SWA ring: a prompt shorter than half the ring, so that one rank's
    slots hold no valid token for the first decode steps, and an unpadded
    prompt longer than the ring;
  * paged: chunked prefill of two requests and paged decode steps over
    the arenas, whole on every rank;
  * ``Scheduler(ctx=...)``'s greedy completions against JAX's
    ``Scheduler``, end-aligned and paged, on the meshes (1, 2) and (2, 2);
  * a cache length the 2 model ranks do not split (15, JAX's ``_div``
    leaves it whole): each rank holds every slot, writes every token and
    scores every slot with no combine -- the padded fused prefill and
    decode at per-row positions (f32 and bf16), the SWA ring (a prompt
    shorter than the ring and one longer), and ``Scheduler(max_len=15,
    bucket=3)``, whose buckets the ranks split or do not;
  * the MoE layer's EP, TP and a2a layouts at a decode step's (B, 1) tokens
    and at 256-token chunks, with the config's own capacity factor, against
    JAX's single-device ``moe_ffn``;
  * ``cache_specs`` and ``make_cell_ctx`` equal to JAX's (no ranks), for
    every registered config's reduced cache, modulo the stacked dim.

The ranks run in two launches: 2 ranks (mesh (1, 2)) and 4 (mesh (2, 2)).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import config as jconfig
from repro import configs as jconfigs
from repro.config import ParallelConfig as JParallelConfig
from repro.core.compat import abstract_mesh
from repro.launch import specs as jspecs
from repro.launch.scheduler import Request as JRequest
from repro.launch.scheduler import Scheduler as JScheduler
from repro.launch.train import reduced as jreduced
from repro.models import encdec as JE
from repro.models import moe as JM
from repro.models import transformer as JT
from repro_torch import config, configs
from repro_torch.config import ParallelConfig
from repro_torch.convert import params_from_jax
from repro_torch.core.mesh import AbstractMesh, P, assemble, launch
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.launch.scheduler import Request, Scheduler
from repro_torch.launch.specs import cache_specs, make_cell_ctx
from repro_torch.models import encdec as E
from repro_torch.models import moe as M
from repro_torch.models import transformer as T
from repro_torch.parallel import steps as S
from repro_torch.parallel.sharding import gather_cache, make_ctx, shard_params
from repro_torch.tree import leaves, leaves_with_path

torch.backends.cuda.matmul.allow_tf32 = False

TOL = dict(atol=1e-5, rtol=1e-5)
BF16 = dict(atol=2e-2, rtol=2e-2)
JPCFG = JParallelConfig(remat="none", fsdp_params=False)
PCFG = ParallelConfig(fsdp_params=False)
B, PROMPT, STEPS, MAX_LEN = 4, 8, 3, 16
LENS = np.array([8, 5, 8, 3], np.int32)
WINDOW = 16
WHOLE = 15                                  # a length the 2 model ranks do not split
BLOCK, CHUNK = 4, 8
SCHED = {"aligned": dict(slots=4, max_len=32, bucket=8),
         "paged": dict(slots=4, max_len=32, paged=True, block=4, chunk=8),
         "aligned_whole": dict(slots=4, max_len=WHOLE, bucket=3)}
# (prompt length, gen, arrival) of the scheduler's requests
REQS = [(11, 6, 0), (5, 4, 0), (0, 3, 1), (9, 5, 2), (14, 3, 2), (3, 6, 4)]
WHOLE_REQS = [(9, 6, 0), (5, 4, 0), (0, 3, 1), (7, 5, 2), (11, 3, 2), (3, 6, 4)]
MOE_SHAPES = {"decode": (4, 1), "chunk": (2, 256)}
MOE_LAYOUTS = {"ep": dict(fsdp_axes=("data",)), "tp": dict(fsdp_axes=("data",)),
               "a2a": dict(fsdp_axes=(), moe_a2a_ep=True)}


def _cfgs(**kw):
    jcfg = jreduced(jconfigs.get("llama3.2-3b")).replace(
        dtype="float32", param_dtype="float32", vocab=64, **kw)
    cfg = configs.reduced(configs.get("llama3.2-3b")).replace(dtype="float32", vocab=64, **kw)
    return jcfg, cfg


def _tokens(shape, seed):
    return np.random.RandomState(seed).randint(0, 64, shape).astype(np.int32)


def _np_cache(jcache):
    """JAX's (K, V) cache stacked over periods -> per-layer float32 pairs."""
    k, v = (np.asarray(a, np.float32) for a in jcache[0]["attn"])
    return [(k[i], v[i]) for i in range(k.shape[0])]


def _requests(cls, engine):
    r = np.random.RandomState(5)
    spec = WHOLE_REQS if engine == "aligned_whole" else REQS
    return [cls(rid=i, prompt=r.randint(0, 64, (lp,)).astype(np.int32), gen=g, arrival=a)
            for i, (lp, g, a) in enumerate(spec)]


def _moe_cfgs(n_experts):
    kw = dict(name="t", family="moe", n_layers=1, d_model=32, n_heads=4, n_kv_heads=4,
              d_ff=64, vocab=64, block_pattern=("attn_moe",), dtype="float32")
    mk = dict(n_experts=n_experts, top_k=2, d_ff_expert=16, n_shared_experts=1)
    return (jconfig.ModelConfig(**kw, moe=jconfig.MoEConfig(**mk)),
            config.ModelConfig(**kw, moe=config.MoEConfig(**mk)))


# ---------------------------------------------------------------------------
# the JAX side
# ---------------------------------------------------------------------------
def _jax_aligned(jcfg, jparams, dtype, max_len=MAX_LEN):
    toks = _tokens((B, PROMPT), 0)
    for i, n in enumerate(LENS):
        toks[i, n:] = 0
    jl, jc = JT.prefill(jparams, jnp.asarray(toks), JT.init_cache(jcfg, B, max_len, dtype), jcfg,
                        length=jnp.asarray(LENS))
    cache0 = _np_cache(jc)
    out, pos = [np.asarray(jl)], jnp.asarray(LENS)
    steps = [_tokens((B,), 10 + i) for i in range(STEPS)]
    for t in steps:
        jl, jc = JT.decode_step(jparams, jnp.asarray(t), jc, pos, jcfg)
        out.append(np.asarray(jl))
        pos = pos + 1
    return {"tokens": toks, "steps": steps, "logits": np.stack(out), "cache": cache0,
            "max_len": max_len}


def _jax_ring(jcfg, jparams, prompt, window=WINDOW):
    toks = _tokens((B, prompt), 1)
    jl, jc = JT.prefill(jparams, jnp.asarray(toks), JT.init_cache(jcfg, B, window, jnp.float32),
                        jcfg)
    out = [np.asarray(jl)]
    steps = [_tokens((B,), 20 + i) for i in range(STEPS)]
    for i, t in enumerate(steps):
        jl, jc = JT.decode_step(jparams, jnp.asarray(t),
                                jc, jnp.full((B,), prompt + i, jnp.int32), jcfg)
        out.append(np.asarray(jl))
    return {"tokens": toks, "steps": steps, "logits": np.stack(out), "window": window}


def _paged_plan():
    """Two requests' prompts (13 and 6 tokens), their block tables over a
    10-block arena (block 4), and 3 decode steps."""
    prompts = [_tokens((13,), 2), _tokens((6,), 3)]
    tables = np.array([[7, 2, 5, 0, 9, 8], [3, 6, 1, -1, -1, -1]], np.int32)
    return prompts, tables, [_tokens((2,), 30 + i) for i in range(STEPS)]


def _jax_paged(jcfg, jparams):
    prompts, tables, steps = _paged_plan()
    jc = JT.init_paged_cache(jcfg, 10, BLOCK, jnp.float32)
    firsts = []
    for r, pr in enumerate(prompts):
        for lo in range(0, len(pr), CHUNK):
            n = min(CHUNK, len(pr) - lo)
            chunk = np.zeros((1, CHUNK), np.int32)
            chunk[0, :n] = pr[lo:lo + n]
            jl, jc = JT.prefill_paged(jparams, jnp.asarray(chunk), jc, jcfg, pos0=lo,
                                      block_tables=jnp.asarray(tables[r:r + 1]), length=n)
        firsts.append(np.asarray(jl)[0])
    out = [np.stack(firsts)]
    pos = jnp.asarray([len(p) for p in prompts], jnp.int32)
    for t in steps:
        jl, jc = JT.decode_step(jparams, jnp.asarray(t), jc, pos, jcfg,
                                block_tables=jnp.asarray(tables))
        out.append(np.asarray(jl))
        pos = pos + 1
    return np.stack(out)


def _jax_moe():
    out = {}
    for n_exp in (4, 3):
        jcfg, _ = _moe_cfgs(n_exp)
        jp = JM.moe_init(jax.random.PRNGKey(n_exp), jcfg)
        for name, shape in MOE_SHAPES.items():
            x = np.random.RandomState(n_exp).randn(*shape, jcfg.d_model).astype(np.float32)
            y, probs = JM.moe_ffn(jp, jnp.asarray(x), jcfg, None)
            out[(n_exp, name)] = (x, np.asarray(y), np.asarray(probs))
        out[n_exp] = {"layers": ({"moe": jax.tree.map(lambda a: np.asarray(a)[None], jp)},),
                      "embed": {}, "final_norm": {}}
    return out


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------
def _aligned_ranks(cfg, params, ctx, case, dtype):
    max_len = case["max_len"]
    cache = T.init_cache(cfg, B, max_len, device="cpu", dtype=dtype, ctx=ctx)
    prefill = S.make_prefill_step(cfg, ctx)
    decode = S.make_decode_step(cfg, return_logits=True, ctx=ctx)
    lg, cache = prefill(params, {"tokens": torch.from_numpy(case["tokens"]),
                                 "length": torch.from_numpy(LENS)}, cache)
    full = gather_cache(cache, cfg, ctx, T.init_cache(cfg, B, max_len, device="meta"))
    out, pos = [lg], torch.from_numpy(LENS).long()
    for t in case["steps"]:
        lg, cache = decode(params, torch.from_numpy(t), cache, pos)
        out.append(lg)
        pos = pos + 1
    return torch.stack(out), [tuple(t.float() for t in kv) for kv in full]


def _ring_ranks(cfg, params, ctx, case):
    prompt = case["tokens"].shape[1]
    cache = T.init_cache(cfg, B, case["window"], device="cpu", dtype=torch.float32, ctx=ctx)
    lg, cache = S.make_prefill_step(cfg, ctx)(params, {"tokens": torch.from_numpy(case["tokens"])},
                                              cache)
    decode = S.make_decode_step(cfg, return_logits=True, ctx=ctx)
    out = [lg]
    for i, t in enumerate(case["steps"]):
        lg, cache = decode(params, torch.from_numpy(t), cache, torch.full((B,), prompt + i))
        out.append(lg)
    return torch.stack(out)


def _paged_ranks(cfg, params, ctx):
    from repro_torch.launch.specs import restrict_batch
    prompts, tables, steps = _paged_plan()
    cache = T.init_paged_cache(cfg, 10, BLOCK, device="cpu", dtype=torch.float32)
    chunk_step = S.make_chunk_prefill_step(cfg, restrict_batch(ctx, 1))
    firsts = []
    for r, pr in enumerate(prompts):
        for lo in range(0, len(pr), CHUNK):
            n = min(CHUNK, len(pr) - lo)
            chunk = torch.zeros((1, CHUNK), dtype=torch.int32)
            chunk[0, :n] = torch.from_numpy(pr[lo:lo + n])
            lg, cache = chunk_step(params, chunk, cache, lo, torch.from_numpy(tables[r:r + 1]), n)
        firsts.append(lg[0])
    decode = S.make_decode_step(cfg, return_logits=True, paged=True, ctx=restrict_batch(ctx, 2))
    out = [torch.stack(firsts)]
    pos = torch.tensor([len(p) for p in prompts])
    for t in steps:
        lg, cache = decode(params, torch.from_numpy(t), cache, pos, torch.from_numpy(tables))
        out.append(lg)
        pos = pos + 1
    return torch.stack(out)


def _sched_ranks(cfg, params, ctx):
    return {name: {r: c.tokens for r, c in
                   Scheduler(cfg, params, ctx=ctx, **kw).run(_requests(Request, name))
                   ["completions"].items()}
            for name, kw in SCHED.items()}


def _moe_ranks(mesh, moe_params):
    out = {}
    for name, kw in MOE_LAYOUTS.items():
        n_exp = 3 if name == "tp" else 4
        _, cfg = _moe_cfgs(n_exp)
        ctx = M.MeshCtx(mesh=mesh, **kw)
        mesh.make_groups(ctx.batch_axes, ctx.fsdp_axes)
        p = params_from_jax(moe_params[n_exp], cfg, device="cpu")["layers"][0]["moe"]
        local = shard_params({"moe": p}, cfg, ctx)["moe"]
        for shape_name, shape in MOE_SHAPES.items():
            x = np.random.RandomState(n_exp).randn(*shape, cfg.d_model).astype(np.float32)
            with mesh:
                y, probs = M.moe_ffn(local, S.local_rows(torch.from_numpy(x), ctx), cfg, ctx)
                out[(name, shape_name)] = (assemble(y, P(ctx.batch_axes), mesh),
                                           assemble(probs, P(ctx.batch_axes), mesh))
    return out


def _ranks(device, model, jparams, cases, moe_params):
    _, cfg = _cfgs()
    mesh = make_local_mesh(model)
    ctx = make_ctx(mesh, PCFG)
    params = shard_params(params_from_jax(jparams, cfg, device="cpu"), cfg, ctx)
    out = {"sched": _sched_ranks(cfg, params, ctx)}
    if mesh.size("data") == 1:
        return out
    out["aligned"] = _aligned_ranks(cfg, params, ctx, cases["aligned"], torch.float32)
    bcfg = cfg.replace(dtype="bfloat16")
    bparams = shard_params(params_from_jax(jparams, bcfg, device="cpu"), bcfg, ctx)
    out["aligned_bf16"] = _aligned_ranks(bcfg, bparams, ctx, cases["aligned_bf16"],
                                         torch.bfloat16)[0].float()
    out["whole"] = _aligned_ranks(cfg, params, ctx, cases["whole"], torch.float32)
    out["whole_bf16"] = _aligned_ranks(bcfg, bparams, ctx, cases["whole_bf16"],
                                       torch.bfloat16)[0].float()
    rcfg = cfg.replace(window=WINDOW)
    out["ring"] = _ring_ranks(rcfg, params, ctx, cases["ring"])
    out["ring_long"] = _ring_ranks(rcfg, params, ctx, cases["ring_long"])
    out["odd"] = _ring_ranks(cfg, params, ctx, cases["odd"])
    out["ring_odd"] = _ring_ranks(rcfg, params, ctx, cases["ring_odd"])
    wcfg = cfg.replace(window=WHOLE)
    out["ring_whole"] = _ring_ranks(wcfg, params, ctx, cases["ring_whole"])
    out["ring_whole_long"] = _ring_ranks(wcfg, params, ctx, cases["ring_whole_long"])
    out["paged"] = _paged_ranks(cfg, params, ctx)
    out["moe"] = _moe_ranks(mesh, moe_params)
    return out


@pytest.fixture(scope="module")
def runs():
    jcfg, _ = _cfgs()
    jparams = JT.init(jax.random.PRNGKey(0), jcfg)
    bjcfg = jcfg.replace(dtype="bfloat16")
    wjcfg = jcfg.replace(window=WINDOW)
    whole_jcfg = jcfg.replace(window=WHOLE)
    want = {"aligned": _jax_aligned(jcfg, jparams, jnp.float32),
            "aligned_bf16": _jax_aligned(bjcfg, jparams, jnp.bfloat16),
            "whole": _jax_aligned(jcfg, jparams, jnp.float32, WHOLE),
            "whole_bf16": _jax_aligned(bjcfg, jparams, jnp.bfloat16, WHOLE),
            "ring": _jax_ring(wjcfg, jparams, 3),
            "ring_long": _jax_ring(wjcfg, jparams, 24),
            "odd": _jax_ring(jcfg, jparams, 7),
            "ring_odd": _jax_ring(wjcfg, jparams, 25),
            "ring_whole": _jax_ring(whole_jcfg, jparams, 3, WHOLE),
            "ring_whole_long": _jax_ring(whole_jcfg, jparams, 24, WHOLE),
            "paged": _jax_paged(jcfg, jparams),
            "moe": _jax_moe()}
    want["sched"] = {name: {r: c.tokens for r, c in
                            JScheduler(jcfg, JPCFG, jparams, **kw).run(_requests(JRequest, name))
                            ["completions"].items()}
                     for name, kw in SCHED.items()}
    nparams = jax.tree.map(np.asarray, jparams)
    cases = {k: want[k] for k in ("aligned", "aligned_bf16", "whole", "whole_bf16", "ring",
                                  "ring_long", "odd", "ring_odd", "ring_whole",
                                  "ring_whole_long")}
    moe_params = {n: want["moe"][n] for n in (4, 3)}
    got = {(1, 2): launch(2, _ranks, 2, nparams, cases, moe_params, device="cpu", timeout=600),
           (2, 2): launch(4, _ranks, 2, nparams, cases, moe_params, device="cpu", timeout=600)}
    return want, got


def _every_rank(got, key):
    return [r[key] for r in got[(2, 2)]]


def test_fused_prefill_and_aligned_decode_match_jax(runs):
    """A right-padded prefill, then decode steps at per-row positions (5,
    8, 3 and 8 on: the rows' tokens land on either rank's slots), f32 cache;
    the prefill's cache, reassembled by ``cache_specs``, equals JAX's."""
    want, got = runs
    for logits, cache in _every_rank(got, "aligned"):
        np.testing.assert_allclose(logits, want["aligned"]["logits"], **TOL)
        for (k, v), (jk, jv) in zip(cache, want["aligned"]["cache"]):
            np.testing.assert_allclose(k, jk, **TOL)
            np.testing.assert_allclose(v, jv, **TOL)


def test_whole_cache_prefill_and_aligned_decode_match_jax(runs):
    """A cache of 15 slots on 2 model ranks: every rank holds the whole
    rows, the padded prefill (8 tokens: the sequence-sharded region) writes
    them on every rank, and each decode step's token too; the ranks score
    every slot with no combine.  The prefill's cache equals JAX's."""
    want, got = runs
    for logits, cache in _every_rank(got, "whole"):
        np.testing.assert_allclose(logits, want["whole"]["logits"], **TOL)
        for (k, v), (jk, jv) in zip(cache, want["whole"]["cache"]):
            np.testing.assert_allclose(k, jk, **TOL)
            np.testing.assert_allclose(v, jv, **TOL)
    for logits in _every_rank(got, "whole_bf16"):
        np.testing.assert_allclose(logits, want["whole_bf16"]["logits"], **BF16)


@pytest.mark.parametrize("case", ["ring_whole", "ring_whole_long"])
def test_whole_ring_matches_jax(runs, case):
    """A 15-slot SWA ring held whole on 2 model ranks: a 3-token prompt (the
    ring's unwritten slots masked) and a 24-token one (its last 15 tokens
    kept at their ring slots), then decode steps."""
    want, got = runs
    for logits in _every_rank(got, case):
        np.testing.assert_allclose(logits, want[case]["logits"], **TOL)


def test_bf16_model_aligned_decode_matches_jax(runs):
    want, got = runs
    for logits in _every_rank(got, "aligned_bf16"):
        np.testing.assert_allclose(logits, want["aligned_bf16"]["logits"], **BF16)


def test_ring_decode_with_an_empty_shard_matches_jax(runs):
    """A 3-token prompt in a 16-slot ring on 2 model ranks: rank 1's slots
    hold no valid token for every step here, and must weigh 0."""
    want, got = runs
    for logits in _every_rank(got, "ring"):
        assert np.isfinite(logits).all()
        np.testing.assert_allclose(logits, want["ring"]["logits"], **TOL)


def test_prompt_longer_than_the_ring_matches_jax(runs):
    """A 24-token prompt into the 16-slot ring (its last 16 tokens kept at
    their ring slots, split over the ranks), then decode steps."""
    want, got = runs
    for logits in _every_rank(got, "ring_long"):
        np.testing.assert_allclose(logits, want["ring_long"]["logits"], **TOL)


@pytest.mark.parametrize("case", ["odd", "ring_odd"])
def test_prefill_that_does_not_split_matches_jax(runs, case):
    """A prompt whose length the 2 model ranks do not split (7 tokens into
    a 16-slot cache; 25 into the 16-slot ring, its last 16 kept): the ranks
    attend the whole gathered K/V, as one process does, then decode."""
    want, got = runs
    for logits in _every_rank(got, case):
        np.testing.assert_allclose(logits, want[case]["logits"], **TOL)


def test_chunked_prefill_and_paged_decode_match_jax(runs):
    want, got = runs
    for logits in _every_rank(got, "paged"):
        np.testing.assert_allclose(logits, want["paged"], **TOL)


@pytest.mark.parametrize("mesh", [(1, 2), (2, 2)])
@pytest.mark.parametrize("engine", list(SCHED))
def test_scheduler_greedy_completions_equal_jax(runs, mesh, engine):
    """Every rank serves the same mix (staggered, an empty prompt, slots
    reused) and returns JAX's greedy tokens."""
    want, got = runs
    for rank in got[mesh]:
        assert rank["sched"][engine] == want["sched"][engine]


@pytest.mark.parametrize("shape", list(MOE_SHAPES))
@pytest.mark.parametrize("layout", list(MOE_LAYOUTS))
def test_moe_layouts_at_serving_shapes_match_jax(runs, layout, shape):
    """The capacity ``max(8, ceil(T k / ep * 1.25))`` at a decode step's 4
    tokens (2 a data shard) and at 256-token chunks drops no assignment of
    these routes: the layouts equal JAX's dropless single-device layer."""
    want, got = runs
    n_exp = 3 if layout == "tp" else 4
    _, y, probs = want["moe"][(n_exp, shape)]
    for rank in got[(2, 2)]:
        gy, gp = rank["moe"][(layout, shape)]
        np.testing.assert_allclose(gy, y, **TOL)
        np.testing.assert_allclose(gp, probs, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# specs (no ranks)
# ---------------------------------------------------------------------------
def _jax_cache_specs(jcfg, jctx):
    init = JE.init_cache if jcfg.enc_dec else JT.init_cache
    cache = jax.eval_shape(lambda: init(jcfg, 4, 64))
    return jspecs.cache_specs(jcfg, jctx, cache)


def _jax_leaf(jtree, cfg, path):
    """JAX's spec of the port cache leaf at ``path`` (layer i: period i //
    len(pattern), kind i % len(pattern)) and the stacked index."""
    if cfg.enc_dec:
        return jtree["attn"][path[1]]
    entry = jtree[path[0] % len(cfg.block_pattern)]
    rest = path[1:]
    if isinstance(rest[0], int):                  # an attention kind's (K, V)
        return entry["attn"][rest[0]]
    for k in rest:
        entry = entry[k]
    return entry


@pytest.mark.parametrize("mesh_shape,axes", [((2, 2), ("data", "model")),
                                             ((1, 8), ("data", "model")),
                                             ((2, 16, 16), ("pod", "data", "model"))])
@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_cache_specs_and_cell_ctx_equal_to_jax(arch, mesh_shape, axes):
    jcfg, cfg = jreduced(jconfigs.get(arch)), configs.reduced(configs.get(arch))
    jmesh, mesh = abstract_mesh(mesh_shape, axes), AbstractMesh(mesh_shape, axes)
    for kw in (dict(), dict(fsdp_params=False), dict(engine_replicate=True)):
        for batch in (1, 2, 4, 64):
            jctx = jspecs.make_cell_ctx(jmesh, JParallelConfig(**kw), batch)
            ctx = make_cell_ctx(mesh, ParallelConfig(**kw), batch)
            assert ctx.batch_axes == jctx.batch_axes and ctx.fsdp_axes == jctx.fsdp_axes
        jtree = _jax_cache_specs(jcfg, jctx)
        init = E.init_cache if cfg.enc_dec else T.init_cache
        port = cache_specs(cfg, ctx, init(cfg, 4, 64, device="meta"))
        n = 0
        for path, spec in leaves_with_path(port):
            want = tuple(_jax_leaf(jtree, cfg, path))
            assert want[0] is None and tuple(spec) == want[1:], (path, spec, want)
            n += 1
        assert n == len(leaves(jtree)) * (cfg.n_layers if cfg.enc_dec else cfg.n_periods) > 0
