"""The enc-dec model (Whisper) under a mesh ctx on 4 gloo CPU ranks (mesh
(2, 2)), against the JAX package's single-device functions on the same
numpy inputs.

  * ``encode`` (non-causal self-attention, the frames split over
    ``model`` in the sequence-sharded region) and ``decode_train``
    (teacher-forced: causal self-attention and cross-attention
    sequence-sharded);
  * the serve steps: ``make_prefill_step`` (the encoder and the decoder's
    fused prefill into the cache, split over ``model`` on its length) and
    three ``make_decode_step``s (the one-token cross-attention against the
    whole encoder K/V); the logits, the encoder output and the cache
    reassembled by ``cache_specs``;
  * two train steps following JAX's single-device trajectory.

f32: outputs and logits 1e-5, the losses 1e-5 relative, the parameters
after the steps normwise 1e-4.  One 4-rank launch.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import config as jconfig
from repro import configs as jconfigs
from repro.launch.train import reduced as jreduced
from repro.models import encdec as JE
from repro.parallel import steps as JS
from repro_torch import configs
from repro_torch.config import ParallelConfig, TrainConfig
from repro_torch.convert import train_state_from_jax
from repro_torch.core.mesh import P, assemble, launch, local_block
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import encdec as E
from repro_torch.parallel import steps as S
from repro_torch.parallel.sharding import gather_cache, make_ctx, shard_params
from repro_torch.tree import leaves, tree_map

torch.backends.cuda.matmul.allow_tf32 = False

TOL = dict(atol=1e-5, rtol=1e-5)
B, FRAMES, PROMPT, STEPS, MAX_LEN = 4, 12, 8, 3, 16
TCFG = dict(lr=1e-3, warmup_steps=1, total_steps=4, z_loss=0.0)


def _cfgs():
    kw = dict(dtype="float32", vocab=64, n_layers=2, d_model=64)
    return (jreduced(jconfigs.get("whisper-base")).replace(**kw),
            configs.reduced(configs.get("whisper-base")).replace(**kw))


def _inputs():
    r = np.random.RandomState(0)
    return {"frames": r.randn(B, FRAMES, 64).astype(np.float32),
            "tokens": r.randint(0, 64, (B, PROMPT)).astype(np.int32),
            "steps": [r.randint(0, 64, (B,)).astype(np.int32) for _ in range(STEPS)],
            "train": [{"tokens": r.randint(0, 64, (B, PROMPT)).astype(np.int32),
                       "frames": r.randn(B, FRAMES, 64).astype(np.float32)} for _ in range(2)]}


def _jax(inp):
    jcfg, _ = _cfgs()
    jp = jconfig.ParallelConfig(remat="none", fsdp_params=False, grad_dtype="float32")
    jstate = JS.init_train_state(jax.random.PRNGKey(0), jcfg, jp)
    params = jstate["params"]
    out = {"init": jax.tree.map(np.asarray, jstate)}
    enc = JE.encode(params, jnp.asarray(inp["frames"]), jcfg)
    out["enc"] = np.asarray(enc)
    out["train_logits"] = np.asarray(JE.decode_train(params, jnp.asarray(inp["tokens"]), enc,
                                                     jcfg))
    lg, cache = JE.decode_prefill(params, jnp.asarray(inp["tokens"]), enc,
                                  JE.init_cache(jcfg, B, MAX_LEN, jnp.float32), jcfg)
    serve = [np.asarray(lg)]
    for i, t in enumerate(inp["steps"]):
        lg, cache = JE.decode_step(params, jnp.asarray(t), cache, jnp.int32(PROMPT + i), enc,
                                   jcfg)
        serve.append(np.asarray(lg))
    out["serve"] = np.stack(serve)
    k, v = (np.asarray(a, np.float32) for a in cache["attn"])
    out["cache"] = [(k[i], v[i]) for i in range(k.shape[0])]
    jstep = jax.jit(JS.make_train_step(jcfg, jp, jconfig.TrainConfig(**TCFG), None))
    metrics = []
    for b in inp["train"]:
        jstate, m = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        metrics.append({k: float(v) for k, v in m.items()})
    out["metrics"], out["final"] = metrics, jax.tree.map(np.asarray, jstate)
    return out


def _ranks(device, init, inp):
    _, cfg = _cfgs()
    mesh = make_local_mesh(2)
    pcfg = ParallelConfig(remat="none", grad_dtype="float32", fsdp_params=False)
    ctx = make_ctx(mesh, pcfg)
    full = train_state_from_jax(init, cfg, device="cpu")
    params = shard_params(full["params"], cfg, ctx)
    rows = lambda a: S.local_rows(torch.from_numpy(np.asarray(a)), ctx)
    out = {}
    with mesh:
        enc = E.encode(params, rows(inp["frames"]), cfg, ctx=ctx)
        out["enc"] = assemble(enc, P("data"), mesh)
        lg = E.decode_train(params, rows(inp["tokens"]), enc, cfg, ctx=ctx)
        out["train_logits"] = S.global_rows(lg, ctx, cfg)
    cache = E.init_cache(cfg, B, MAX_LEN, device="cpu", dtype=torch.float32, ctx=ctx)
    prefill = S.make_prefill_step(cfg, ctx)
    decode = S.make_decode_step(cfg, return_logits=True, ctx=ctx)
    lg, cache, genc = prefill(params, {"tokens": torch.from_numpy(inp["tokens"]),
                                       "frames": torch.from_numpy(inp["frames"])}, cache)
    out["step_enc"] = genc
    serve = [lg]
    for i, t in enumerate(inp["steps"]):
        lg, cache = decode(params, torch.from_numpy(t), cache, torch.tensor(PROMPT + i), genc)
        serve.append(lg)
    out["serve"] = torch.stack(serve)
    out["cache"] = gather_cache(cache, cfg, ctx, E.init_cache(cfg, B, MAX_LEN, device="meta"))
    specs = S.train_state_shardings(cfg, pcfg, ctx, full)
    state = tree_map(lambda x, s: local_block(x, s, mesh).clone(), full, specs)
    step = S.make_train_step(cfg, pcfg, TrainConfig(**TCFG), ctx)
    metrics = []
    for b in inp["train"]:
        state, m = step(state, {k: rows(v) for k, v in b.items()})
        metrics.append({k: float(v) for k, v in m.items()})
    with mesh:
        out["params"] = [assemble(x, s, mesh) for x, s in zip(leaves(state["params"]),
                                                              leaves(specs["params"]))]
    out["metrics"] = metrics
    return out


@pytest.fixture(scope="module")
def runs():
    inp = _inputs()
    want = _jax(inp)
    return want, launch(4, _ranks, want["init"], inp, device="cpu", timeout=600)


def test_encode_and_decode_train_match_jax(runs):
    want, got = runs
    for rank in got:
        np.testing.assert_allclose(rank["enc"], want["enc"], **TOL)
        np.testing.assert_allclose(rank["train_logits"], want["train_logits"], **TOL)


def test_prefill_and_decode_steps_match_jax(runs):
    want, got = runs
    for rank in got:
        np.testing.assert_allclose(rank["step_enc"], want["enc"], **TOL)
        np.testing.assert_allclose(rank["serve"], want["serve"], **TOL)
        for (k, v), (jk, jv) in zip(rank["cache"], want["cache"]):
            np.testing.assert_allclose(k, jk, **TOL)
            np.testing.assert_allclose(v, jv, **TOL)


def test_train_steps_follow_the_jax_trajectory(runs):
    want, got = runs
    _, cfg = _cfgs()
    run = got[0]
    for m, jm in zip(run["metrics"], want["metrics"]):
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(m[k], jm[k], rtol=1e-5)
    final = leaves(train_state_from_jax(want["final"], cfg, device="cpu")["params"])
    assert len(run["params"]) == len(final)
    for g, w in zip(run["params"], final):
        w = w.numpy()
        assert np.linalg.norm(g - w) <= 1e-4 * max(np.linalg.norm(w), 1e-30)
