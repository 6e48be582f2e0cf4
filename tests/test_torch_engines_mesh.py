"""The recurrent engines and blocks under a mesh ctx on gloo CPU ranks
(mesh (2, 2): batch over ``data``, the engine over ``model``), against the
JAX package's single-device functions on the same numpy inputs.

  * ``engine_specs`` equal to JAX's over a grid of (heads, dk, model size,
    ``engine_replicate``, ``dp_over_model``), JAX's read through a stub ctx
    (no ranks);
  * ``chunked_linear_attention`` in the head-split layout (4 heads) and
    the dk-split layout (3 heads, dk 8: the partial scores summed over
    ``model`` each chunk), from a carried state: outputs and final state;
  * ``mamba2_block`` (8 heads, split; the conv window's channels split),
    ``mlstm_block`` (4 heads split; 1 head, dk split) and ``slstm_block``
    (channels split) with a cache: a 16-token fused prefill, then two
    decode steps, the outputs and the cache (reassembled by
    ``cache_specs``) against JAX's;
  * the hybrid (Mamba2 + shared attention) and xLSTM models: the fused
    prefill and decode steps of the serve steps, and two train steps
    following JAX's single-device trajectory.

f32 throughout: outputs, caches and losses 1e-5; the parameters after the
train steps normwise 1e-4 (``tests/test_torch_train_mesh.py``'s bound).
Every rank computation runs in one 4-rank launch.
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import config as jconfig
from repro import configs as jconfigs
from repro.launch.train import reduced as jreduced
from repro.models import ssm as JS_
from repro.models import transformer as JT
from repro.models import xlstm as JX
from repro.parallel import steps as JS
from repro_torch import configs
from repro_torch.config import ParallelConfig, TrainConfig
from repro_torch.convert import train_state_from_jax
from repro_torch.core.mesh import P, assemble, launch, local_block
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import ssm as S_
from repro_torch.models import transformer as T
from repro_torch.models import xlstm as X
from repro_torch.parallel import steps as S
from repro_torch.parallel.sharding import gather_cache, make_ctx, shard_cache, shard_params
from repro_torch.tree import leaves, tree_map

torch.backends.cuda.matmul.allow_tf32 = False

TOL = dict(atol=1e-5, rtol=1e-5)
B, SEQ, CHUNK, STEPS = 4, 16, 8, 2
PCFG = ParallelConfig(fsdp_params=False)
TCFG = dict(lr=1e-3, warmup_steps=1, total_steps=4, z_loss=0.0)
ENGINES = {"heads": (4, 8), "dk": (3, 8)}           # layout -> (heads, dk)
# block -> (arch, config changes)
BLOCKS = {"mamba2": ("zamba2-1.2b", dict(block_pattern=("mamba2",))),
          "mlstm": ("xlstm-1.3b", dict(block_pattern=("mlstm",))),
          "mlstm-dk": ("xlstm-1.3b", dict(block_pattern=("mlstm",), n_heads=1)),
          "slstm": ("xlstm-1.3b", dict(block_pattern=("slstm",)))}
MODELS = {"hybrid": ("zamba2-1.2b", dict(block_pattern=("mamba2", "mamba2_attn"))),
          "xlstm": ("xlstm-1.3b", dict(block_pattern=("mlstm", "slstm")))}


def _cfgs(arch, **kw):
    kw = dict(dtype="float32", vocab=64, n_layers=2, d_model=64, **kw)
    out = []
    for c in (jreduced(jconfigs.get(arch)), configs.reduced(configs.get(arch))):
        extra = {n: dataclasses.replace(getattr(c, n), chunk=CHUNK)
                 for n in ("ssm", "xlstm") if getattr(c, n)}
        out.append(c.replace(**kw, **extra))
    return out


def _kind(name):
    return name.split("-")[0]


# ---------------------------------------------------------------------------
# engine_specs (no ranks)
# ---------------------------------------------------------------------------
def test_engine_specs_equal_to_jax():
    n = 0
    for nh in (1, 3, 4, 8, 64):
        for dk in (8, 12, 64, 1024):
            for p in (1, 2, 4, 8, 16):
                for rep in (False, True):
                    for dpom in (False, True):
                        kw = dict(model_size=p, model_axis="model", engine_replicate=rep,
                                  dp_over_model=dpom)
                        ctx = types.SimpleNamespace(**kw)
                        assert S_.engine_specs(nh, dk, ctx) == JS_.engine_specs(nh, dk, ctx)
                        n += 1
    assert S_.engine_specs(4, 8, None) == JS_.engine_specs(4, 8, None) == (None, None)
    assert S_.engine_specs(4, 1024, types.SimpleNamespace(
        model_size=8, model_axis="model", engine_replicate=False, dp_over_model=False)) \
        == (None, "model")
    assert n == 400


# ---------------------------------------------------------------------------
# the JAX side
# ---------------------------------------------------------------------------
def _engine_inputs(h, dk):
    r = np.random.RandomState(h)
    f = lambda *s: r.randn(*s).astype(np.float32)
    return dict(q=f(B, SEQ, h, dk) * 0.5, k=f(B, SEQ, h, dk) * 0.5, v=f(B, SEQ, h, 5),
                log_a=-np.abs(f(B, SEQ, h)) * 0.1, gate=np.abs(f(B, SEQ, h)),
                state0=f(B, h, dk, 5))


def _jax_engine(inp):
    y, state = JS_.chunked_linear_attention(
        *(jnp.asarray(inp[k]) for k in ("q", "k", "v", "log_a", "gate")), chunk=CHUNK,
        state0=jnp.asarray(inp["state0"]))
    return np.asarray(y), np.asarray(state)


def _jax_block(name):
    arch, kw = BLOCKS[name]
    jcfg, _ = _cfgs(arch, **kw)
    kind = _kind(name)
    init, block = {"mamba2": (JS_.mamba2_init, JS_.mamba2_block),
                   "mlstm": (JX.mlstm_init, JX.mlstm_block),
                   "slstm": (JX.slstm_init, JX.slstm_block)}[kind]
    jp = init(jax.random.PRNGKey(1), jcfg)
    cache = jax.tree.map(lambda a: a[0], JT.init_cache(jcfg, B, SEQ)[0])[
        {"mamba2": "mamba"}.get(kind, kind)]
    r = np.random.RandomState(2)
    x = r.randn(B, SEQ, jcfg.d_model).astype(np.float32)
    steps = [r.randn(B, 1, jcfg.d_model).astype(np.float32) for _ in range(STEPS)]
    ys = []
    y, cache = block(jp, jnp.asarray(x), jcfg, cache=cache)
    ys.append(np.asarray(y))
    for xt in steps:
        y, cache = block(jp, jnp.asarray(xt), jcfg, cache=cache)
        ys.append(np.asarray(y))
    return {"params": jax.tree.map(np.asarray, jp), "x": x, "steps": steps,
            "y": np.concatenate(ys, axis=1), "cache": jax.tree.map(np.asarray, cache)}


def _jax_model(name):
    arch, kw = MODELS[name]
    jcfg, _ = _cfgs(arch, **kw)
    jp = jconfig.ParallelConfig(remat="none", fsdp_params=False, grad_dtype="float32")
    jstate = JS.init_train_state(jax.random.PRNGKey(0), jcfg, jp)
    init = jax.tree.map(np.asarray, jstate)
    toks = [np.random.RandomState(7 + s).randint(0, 64, (B, SEQ)).astype(np.int32)
            for s in range(2)]
    # serving: a fused prefill (unpadded) and decode steps
    lg, cache = JT.prefill(jstate["params"], jnp.asarray(toks[0]),
                           JT.init_cache(jcfg, B, 2 * SEQ, jnp.float32), jcfg)
    serve = [np.asarray(lg)]
    for i in range(STEPS):
        lg, cache = JT.decode_step(jstate["params"], jnp.asarray(toks[1][:, i]), cache,
                                   jnp.full((B,), SEQ + i, jnp.int32), jcfg)
        serve.append(np.asarray(lg))
    jstep = jax.jit(JS.make_train_step(jcfg, jp, jconfig.TrainConfig(**TCFG), None))
    metrics = []
    for t in toks:
        jstate, m = jstep(jstate, {"tokens": jnp.asarray(t)})
        metrics.append({k: float(v) for k, v in m.items()})
    return {"init": init, "tokens": toks, "serve": np.stack(serve), "metrics": metrics,
            "final": jax.tree.map(np.asarray, jstate)}


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------
def _rows(t, mesh):
    n = t.shape[0] // mesh.size("data")
    return torch.from_numpy(np.asarray(t)).narrow(0, mesh.index("data") * n, n)


def _block_ranks(name, case, ctx):
    arch, kw = BLOCKS[name]
    _, cfg = _cfgs(arch, **kw)
    kind = _kind(name)
    block = {"mamba2": S_.mamba2_block, "mlstm": X.mlstm_block, "slstm": X.slstm_block}[kind]
    group = {"mamba2": "mamba"}.get(kind, kind)
    mesh = ctx.mesh
    p = tree_map(torch.from_numpy, case["params"])
    p = shard_params({"layers": [{group: p}]}, cfg, ctx)["layers"][0][group]
    whole = [{group: tree_map(lambda a: torch.zeros(a.shape), case["cache"])}]
    if kind == "slstm":
        whole[0][group]["m"].fill_(X.M_INIT)
    cache = shard_cache(whole, cfg, ctx)[0][group]
    ys = []
    with mesh:
        y, cache = block(p, _rows(case["x"], mesh), cfg, cache=cache, ctx=ctx)
        ys.append(y)
        for xt in case["steps"]:
            y, cache = block(p, _rows(xt, mesh), cfg, cache=cache, ctx=ctx)
            ys.append(y)
        y = assemble(torch.cat(ys, dim=1), P("data"), mesh)
    full = gather_cache([{group: cache}], cfg, ctx, whole)[0][group]
    return y, full


def _engine_ranks(inp, ctx):
    mesh = ctx.mesh
    t = {k: _rows(v, mesh) for k, v in inp.items()}
    with mesh:
        y, state = S_.sharded_engine(t["q"], t["k"], t["v"], t["log_a"], t["gate"],
                                     t["q"].shape[-1], ctx, chunk=CHUNK, state0=t["state0"],
                                     state_dim=None, mm_bf16=False)
        return assemble(y, P("data"), mesh), assemble(state, P("data"), mesh)


def _model_ranks(name, case, mesh):
    arch, kw = MODELS[name]
    _, cfg = _cfgs(arch, **kw)
    pcfg = ParallelConfig(remat="none", grad_dtype="float32", fsdp_params=False)
    ctx = make_ctx(mesh, pcfg)
    full = train_state_from_jax(case["init"], cfg, device="cpu")
    params = shard_params(full["params"], cfg, ctx)
    toks = case["tokens"]
    cache = T.init_cache(cfg, B, 2 * SEQ, device="cpu", dtype=torch.float32, ctx=ctx)
    lg, cache = S.make_prefill_step(cfg, ctx)(params, {"tokens": torch.from_numpy(toks[0])},
                                              cache)
    decode = S.make_decode_step(cfg, return_logits=True, ctx=ctx)
    serve = [lg]
    for i in range(STEPS):
        lg, cache = decode(params, torch.from_numpy(toks[1][:, i]), cache,
                           torch.full((B,), SEQ + i))
        serve.append(lg)
    specs = S.train_state_shardings(cfg, pcfg, ctx, full)
    state = tree_map(lambda x, s: local_block(x, s, mesh).clone(), full, specs)
    step = S.make_train_step(cfg, pcfg, TrainConfig(**TCFG), ctx)
    metrics = []
    for t in toks:
        state, m = step(state, {"tokens": _rows(t, mesh)})
        metrics.append({k: float(v) for k, v in m.items()})
    with mesh:
        ps = [assemble(x, s, mesh) for x, s in zip(leaves(state["params"]),
                                                   leaves(specs["params"]))]
    return {"serve": torch.stack(serve), "metrics": metrics, "params": ps}


def _ranks(device, engines, blocks, models):
    mesh = make_local_mesh(2)
    ctx = make_ctx(mesh, PCFG)
    out = {("engine", k): _engine_ranks(v, ctx) for k, v in engines.items()}
    out.update({("block", k): _block_ranks(k, v, ctx) for k, v in blocks.items()})
    out.update({("model", k): _model_ranks(k, v, mesh) for k, v in models.items()})
    return out


@pytest.fixture(scope="module")
def runs():
    engines = {k: _engine_inputs(*hd) for k, hd in ENGINES.items()}
    blocks = {k: _jax_block(k) for k in BLOCKS}
    models = {k: _jax_model(k) for k in MODELS}
    want = {("engine", k): _jax_engine(v) for k, v in engines.items()}
    got = launch(4, _ranks, engines, blocks, models, device="cpu", timeout=600)
    return want, blocks, models, got


@pytest.mark.parametrize("layout", list(ENGINES))
def test_chunked_linear_attention_layouts_match_jax(runs, layout):
    want, _, _, got = runs
    y, state = want[("engine", layout)]
    for rank in got:
        gy, gs = rank[("engine", layout)]
        np.testing.assert_allclose(gy, y, **TOL)
        np.testing.assert_allclose(gs, state, **TOL)


@pytest.mark.parametrize("name", list(BLOCKS))
def test_blocks_with_a_cache_match_jax(runs, name):
    """A fused prefill, then two decode steps, through the block under a
    ctx: the outputs and the cache (in ``cache_specs``'s layout on the
    ranks, reassembled) equal JAX's."""
    _, blocks, _, got = runs
    for rank in got:
        y, cache = rank[("block", name)]
        np.testing.assert_allclose(y, blocks[name]["y"], **TOL)
        for key, want in blocks[name]["cache"].items():
            np.testing.assert_allclose(cache[key], want, **TOL)


@pytest.mark.parametrize("name", list(MODELS))
def test_model_prefill_and_decode_match_jax(runs, name):
    _, _, models, got = runs
    for rank in got:
        np.testing.assert_allclose(rank[("model", name)]["serve"], models[name]["serve"], **TOL)


@pytest.mark.parametrize("name", list(MODELS))
def test_train_steps_follow_the_jax_trajectory(runs, name):
    _, _, models, got = runs
    arch, kw = MODELS[name]
    _, cfg = _cfgs(arch, **kw)
    run = got[0][("model", name)]
    for m, jm in zip(run["metrics"], models[name]["metrics"]):
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(m[k], jm[k], rtol=1e-5)
    want = leaves(train_state_from_jax(models[name]["final"], cfg, device="cpu")["params"])
    assert len(run["params"]) == len(want)
    for g, w in zip(run["params"], want):
        w = w.numpy()
        assert np.linalg.norm(g - w) <= 1e-4 * max(np.linalg.norm(w), 1e-30)
