"""The MoE layer's three mesh layouts on 4 gloo CPU ranks (mesh data 2 x
model 2) against the single-process layer, and MoE train steps on that
mesh against the single-process trajectory.

  * ``moe_ffn`` under the EP layout (8 experts over ``model``, FSDP over
    ``data``), the TP layout (3 experts: each rank a d_ff slice) and the
    a2a layout (experts resident over ``data``, tokens sent to them):
    outputs within rtol 2e-2, atol 2e-3 of ``moe_ffn(ctx=None)`` (the
    bound of ``tests/progs/moe_ep_prog.py``; in f32 they agree to about
    1e-6), router probabilities 1e-5.  The layer's parameters come from the
    JAX init through ``repro_torch.convert``; the capacity factor (8) is
    high enough that no assignment drops, as the reference's program has it;
  * two train steps of a two-layer MoE model (f32 compute and gradients)
    in the EP + FSDP, TP, a2a and pure data-parallel (``dp_over_model`` +
    FSDP: every expert whole on each rank) layouts: loss, aux loss and gradient norm
    within 1e-5 relative, the parameters after the steps within 1e-4
    normwise of one process's steps from the same state.

Every rank computation runs inside one module-scoped launch.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import config as jconfig
from repro.models import moe as JM
from repro_torch import config, configs
from repro_torch.config import ParallelConfig, TrainConfig
from repro_torch.convert import params_from_jax
from repro_torch.core.mesh import P, assemble, launch, local_block
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import moe as M
from repro_torch.parallel import steps as S
from repro_torch.parallel.sharding import make_ctx, shard_params
from repro_torch.tree import leaves, tree_map

B, SEQ, D = 8, 4, 32
FFN_TOL = dict(rtol=2e-2, atol=2e-3)
LAYER_CTX = {                       # layout -> (config, MeshCtx fields)
    "ep": ("eight", dict(fsdp_axes=("data",))),
    "tp": ("three", dict(fsdp_axes=("data",))),
    "a2a": ("eight", dict(fsdp_axes=(), moe_a2a_ep=True)),
}
TRAIN = {                           # layout -> (n_experts, ParallelConfig fields)
    "ep-fsdp": (4, dict(fsdp_params=True)),
    "tp": (3, dict(fsdp_params=False)),
    "a2a": (4, dict(fsdp_params=False, moe_a2a_ep=True)),
    "dpom-fsdp": (4, dict(fsdp_params=True, dp_over_model=True)),
}
STEPS, TBATCH, TSEQ = 2, 4, 8
TCFG = dict(lr=3e-3, warmup_steps=1, total_steps=4, z_loss=0.0)


def _layer_cfgs(n_experts, shared):
    kw = dict(name="t", family="moe", n_layers=1, d_model=D, n_heads=4, n_kv_heads=4,
              d_ff=64, vocab=64, block_pattern=("attn_moe",), dtype="float32")
    mk = dict(n_experts=n_experts, top_k=2, d_ff_expert=16, n_shared_experts=shared,
              capacity_factor=8.0)
    return (jconfig.ModelConfig(**kw, moe=jconfig.MoEConfig(**mk)),
            config.ModelConfig(**kw, moe=config.MoEConfig(**mk)))


def _train_cfg(n_experts):
    cfg = configs.reduced(configs.get("mixtral-8x22b"))
    return cfg.replace(dtype="float32", vocab=64, n_layers=2, window=None,
                       moe=dataclasses.replace(cfg.moe, n_experts=n_experts,
                                               capacity_factor=8.0))


def _pcfg(**kw):
    return ParallelConfig(remat="none", grad_dtype="float32", **kw)


def _ranks(device, layer_params, x, toks, states):
    mesh = make_local_mesh(2)
    rows = B // mesh.size("data")
    i = mesh.index("data")
    out = {}
    for name, (key, kw) in LAYER_CTX.items():
        cfg = _layer_cfgs(8 if key == "eight" else 3, 1 if key == "eight" else 0)[1]
        ctx = M.MeshCtx(mesh=mesh, **kw)
        mesh.make_groups(ctx.batch_axes, ctx.fsdp_axes)
        p = params_from_jax(layer_params[key], cfg, device="cpu")["layers"][0]["moe"]
        local = shard_params({"moe": p}, cfg, ctx)["moe"]
        with mesh:
            y, probs = M.moe_ffn(local, torch.from_numpy(x[i * rows:(i + 1) * rows]), cfg, ctx)
            out[name] = (assemble(y, P("data"), mesh), assemble(probs, P("data"), mesh))
    tcfg = TrainConfig(**TCFG)
    trows = TBATCH // mesh.size("data")
    for name, (n_exp, kw) in TRAIN.items():
        cfg, pcfg = _train_cfg(n_exp), _pcfg(**kw)
        ctx = make_ctx(mesh, pcfg)
        specs = S.train_state_shardings(cfg, pcfg, ctx, states[name])
        state = tree_map(lambda t, s: local_block(torch.from_numpy(np.array(t)), s, mesh)
                         .clone(), states[name], specs)
        step = S.make_train_step(cfg, pcfg, tcfg, ctx)
        metrics = []
        for t in toks:
            state, m = step(state, {"tokens": torch.from_numpy(t[i * trows:(i + 1) * trows])})
            metrics.append({k: float(v) for k, v in m.items()})
        out["train-" + name] = (metrics, [assemble(x_, s, mesh) for x_, s in
                                          zip(leaves(state["params"]),
                                              leaves(specs["params"]))])
    return out


@pytest.fixture(scope="module")
def runs():
    layer_params, refs = {}, {}
    x = np.random.RandomState(1).randn(B, SEQ, D).astype(np.float32)
    for key, n_exp, shared, seed in (("eight", 8, 1, 0), ("three", 3, 0, 2)):
        jcfg, cfg = _layer_cfgs(n_exp, shared)
        jp = JM.moe_init(jax.random.PRNGKey(seed), jcfg)
        layer_params[key] = {"layers": ({"moe": jax.tree.map(lambda a: np.asarray(a)[None],
                                                             jp)},),
                             "embed": {}, "final_norm": {}}
        p = params_from_jax(layer_params[key], cfg, device="cpu")["layers"][0]["moe"]
        refs[key] = M.moe_ffn(p, torch.from_numpy(x), cfg)
    toks = [np.random.RandomState(7 + s).randint(0, 64, (TBATCH, TSEQ)).astype(np.int32)
            for s in range(STEPS)]
    states, single = {}, {}
    for name, (n_exp, kw) in TRAIN.items():
        cfg, pcfg = _train_cfg(n_exp), _pcfg(**kw)
        state = S.init_train_state(torch.Generator().manual_seed(3), cfg, _pcfg())
        states[name] = tree_map(lambda t: t.numpy().copy(), state)
        step = S.make_train_step(cfg, _pcfg(), TrainConfig(**TCFG))
        metrics = []
        for t in toks:
            state, m = step(state, {"tokens": torch.from_numpy(t)})
            metrics.append({k: float(v) for k, v in m.items()})
        single[name] = (metrics, leaves(state["params"]))
    got = launch(4, _ranks, layer_params, x, toks, states, device="cpu", timeout=600)
    return refs, single, got


@pytest.mark.parametrize("layout", list(LAYER_CTX))
def test_moe_ffn_layouts_match_one_process(runs, layout):
    refs, _, got = runs
    ref_y, ref_p = refs[LAYER_CTX[layout][0]]
    for rank in got:                       # every rank holds the global result
        y, probs = rank[layout]
        np.testing.assert_allclose(y, ref_y.numpy(), **FFN_TOL)
        np.testing.assert_allclose(probs, ref_p.numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("layout", list(TRAIN))
def test_moe_train_steps_match_one_process(runs, layout):
    _, single, got = runs
    want_m, want_p = single[layout]
    got_m, got_p = got[0]["train-" + layout]
    for gm, wm in zip(got_m, want_m):
        for key in ("loss", "aux", "grad_norm"):
            assert abs(gm[key] - wm[key]) <= 1e-5 * abs(wm[key]), (key, gm[key], wm[key])
        assert wm["aux"] > 0
    for a, b in zip(got_p, want_p):
        b = b.float().numpy()
        assert np.linalg.norm(a - b) <= 1e-4 * np.linalg.norm(b)
