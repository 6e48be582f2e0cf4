"""The port's trainer against the JAX package's: configs, init dtypes, loss
and gradients, a train-step trajectory, recovery and the launcher.

JAX initialises the state, ``repro_torch.convert`` carries it over, and the
same numpy token batches (made from a seed) go through both packages.
Tolerances, f32: loss relative 1e-5, each gradient leaf normwise 1e-4 (the
packages differ only in summation order, across the layers, the
vocabulary projection and the backward pass); bf16 compute: 2e-2 for both
(one bf16 rounding, 2**-8, at different places in each of a few ops).
Parameters are compared normwise, never elementwise: AdamW's first step is
nearly sign(g), so an entry whose gradient is near 0 can move either way
in two right implementations.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro import config as jconfig
from repro import configs as jconfigs
from repro.launch.train import reduced as jreduced
from repro.models import transformer as JT
from repro.parallel import steps as JS
from repro_torch import checkpoint as ckpt
from repro_torch import config, configs
from repro_torch.config import ParallelConfig, ShapeConfig, TrainConfig
from repro_torch.convert import params_from_jax, train_state_from_jax
from repro_torch.data import make_batch_iterator
from repro_torch.launch import train as launcher
from repro_torch.models import transformer as T
from repro_torch.parallel import steps as S
from repro_torch.runtime import ElasticPlan, StepWatchdog, TrainingRunner
from repro_torch.tree import leaves, tree_map, tree_unflatten

# f32 products in full f32 (no TF32) wherever these tests meet a CUDA device
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ROOT = Path(__file__).resolve().parent.parent
DENSE = ["llama3.2-3b", "chatglm3-6b", "command-r-plus-104b", "llama3-405b", "chameleon-34b"]
TOL = {"float32": (1e-5, 1e-4), "bfloat16": (2e-2, 2e-2)}       # loss, grads


def _cfgs(arch="llama3.2-3b", dtype="float32", **kw):
    jcfg = jreduced(jconfigs.get(arch)).replace(dtype=dtype, **kw)
    cfg = configs.reduced(configs.get(arch)).replace(dtype=dtype, **kw)
    return jcfg, cfg


def _tokens(cfg, b=2, s=16, seed=0):
    return np.random.RandomState(seed).randint(0, cfg.vocab, (b, s)).astype(np.int32)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _normwise(got, want):
    return float((got.float() - want.float()).norm() / want.float().norm())


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------
# the port's own fields (per-layer windows, YaRN): unset in every arch the
# reference names
PORT_ONLY = ("layer_windows", "yarn")


def _shared_fields(cfg) -> dict:
    d = dataclasses.asdict(cfg)
    assert all(d.pop(k) is None for k in PORT_ONLY)
    return d


@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_arch_configs_equal_to_jax(arch):
    mine, ref = configs.get(arch), jconfigs.get(arch)
    assert _shared_fields(mine) == dataclasses.asdict(ref)
    assert mine.param_counts() == ref.param_counts()
    assert _shared_fields(configs.reduced(mine)) == dataclasses.asdict(jreduced(ref))
    assert [s.name for s in configs.shapes_for(arch)] == \
        [s.name for s in jconfigs.shapes_for(arch)]


def test_registry_shapes_and_defaults_equal_to_jax():
    assert configs.ARCHS == jconfigs.ARCHS
    assert configs.cells() == jconfigs.cells()
    assert {k: dataclasses.asdict(v) for k, v in config.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jconfig.SHAPES.items()}
    assert config.SHAPES["decode_32k"].is_decode and not config.SHAPES["train_4k"].is_decode
    assert dataclasses.asdict(ParallelConfig()) == dataclasses.asdict(jconfig.ParallelConfig())
    assert dataclasses.asdict(TrainConfig()) == dataclasses.asdict(jconfig.TrainConfig())


def test_non_attn_families_still_raise():
    """The other families build and train on one process
    (``test_torch_families.py``) and, once raising here, under a mesh ctx
    too: the train step of every family builds on the ctx (the steps
    themselves run on gloo ranks in ``test_torch_engines_mesh.py``,
    ``test_torch_encdec_mesh.py`` and ``test_torch_moe_mesh.py``), and the
    state's specs cover every leaf of the family's tree."""
    from repro_torch.core.mesh import AbstractMesh
    from repro_torch.parallel.sharding import make_ctx
    pcfg = ParallelConfig(fsdp_params=False)
    ctx = make_ctx(AbstractMesh((1, 2), ("data", "model")), pcfg)
    for arch in ("xlstm-1.3b", "zamba2-1.2b", "whisper-base", "mixtral-8x22b"):
        cfg = configs.reduced(configs.get(arch))
        T.init(cfg, torch.Generator().manual_seed(0))
        assert callable(S.make_train_step(cfg, pcfg, TrainConfig(), ctx))
        like = S.abstract_train_state(cfg, pcfg)
        specs = S.train_state_shardings(cfg, pcfg, ctx, like)
        assert len(leaves(specs["params"])) == len(leaves(like["params"])) > 0


# ---------------------------------------------------------------------------
# init dtypes (f32 master parameters, as JAX's init)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", DENSE)
def test_init_dtypes_and_shapes_equal_to_jax(arch):
    jcfg, cfg = jreduced(jconfigs.get(arch)), configs.reduced(configs.get(arch))
    jparams = jax.eval_shape(lambda: JT.init(jax.random.PRNGKey(0), jcfg))
    want = params_from_jax(jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), jparams),
                           cfg, device="meta", dtype=torch.float32)
    got = T.init(cfg, torch.Generator().manual_seed(0))
    desc = lambda t: (tuple(t.shape), t.dtype)
    assert {str(a.dtype) for a in jax.tree.leaves(jparams)} == {"float32"}
    assert tree_map(desc, got) == tree_map(desc, want)
    assert tree_map(desc, T.init(cfg, None)) == tree_map(desc, want)      # meta init
    assert all(t.device.type == "meta" for t in leaves(T.init(cfg, None)))


def test_bf16_serving_init_equals_the_master_init():
    """The serving entry points ask for bf16 matrices: the same draws
    rounded once, so ``forward`` gives the same logits, bit for bit."""
    cfg = configs.reduced(configs.get("llama3.2-3b"))
    master = T.init(cfg, torch.Generator().manual_seed(3))
    served = T.init(cfg, torch.Generator().manual_seed(3), dtype=torch.bfloat16)
    for m, s in zip(leaves(master), leaves(served)):
        assert s.dtype == (torch.bfloat16 if m.dim() > 1 else torch.float32)
        assert torch.equal(m.to(s.dtype), s)
    toks = torch.from_numpy(_tokens(cfg))
    assert torch.equal(T.forward(master, toks, cfg), T.forward(served, toks, cfg))


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("z_loss,chunk", [(0.0, None), (1e-4, None), (0.0, 4), (0.0, 5),
                                          (1e-2, 8)])
def test_cross_entropy_matches_jax(z_loss, chunk):
    rng = np.random.RandomState(1)
    logits = (rng.randn(2, 13, 33) * 3).astype(np.float32)
    labels = rng.randint(0, 33, (2, 13)).astype(np.int32)
    want = float(JS.cross_entropy(jnp.asarray(logits), jnp.asarray(labels), z_loss=z_loss,
                                  chunk=chunk))
    got = S.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels), z_loss=z_loss,
                          chunk=chunk)
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(float(got), want, rtol=1e-6)


def test_cross_entropy_matches_naive():
    rng = np.random.RandomState(2)
    logits = rng.randn(3, 9, 17).astype(np.float32)
    labels = rng.randint(0, 17, (3, 9))
    lp = torch.log_softmax(torch.from_numpy(logits).double(), -1).numpy()
    want = -np.mean([lp[i, j, labels[i, j]] for i in range(3) for j in range(9)])
    got = S.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels))
    np.testing.assert_allclose(float(got), want, rtol=1e-6)


def _jax_loss_and_grads(jcfg, jparams, toks, remat):
    jp = jconfig.ParallelConfig(remat=remat, fsdp_params=False)
    loss_fn = JS.make_loss_fn(jcfg, jp, jconfig.TrainConfig(), None)
    (loss, metrics), grads = jax.value_and_grad(loss_fn, has_aux=True)(
        jparams, {"tokens": jnp.asarray(toks)})
    return float(loss), float(metrics["aux"]), grads


def _port_loss_and_grads(cfg, params, toks, remat):
    loss_fn = S.make_loss_fn(cfg, ParallelConfig(remat=remat, fsdp_params=False),
                             TrainConfig())
    live = [p.detach().requires_grad_(True) for p in leaves(params)]
    loss, metrics = loss_fn(tree_unflatten(params, live), {"tokens": torch.from_numpy(toks)})
    grads = torch.autograd.grad(loss, live, allow_unused=True, materialize_grads=True)
    return float(loss.detach()), float(metrics["aux"]), grads


def _check_loss_and_grads(arch, dtype, remat):
    jcfg, cfg = _cfgs(arch, dtype)
    jparams = JT.init(jax.random.PRNGKey(0), jcfg)
    params = params_from_jax(_np(jparams), cfg, device="cpu", dtype=torch.float32)
    toks = _tokens(cfg)
    jloss, jaux, jgrads = _jax_loss_and_grads(jcfg, jparams, toks, remat)
    loss, aux, grads = _port_loss_and_grads(cfg, params, toks, remat)
    loss_tol, grad_tol = TOL[dtype]
    assert aux == jaux == 0.0
    assert abs(loss - jloss) <= loss_tol * abs(jloss), (loss, jloss)
    want = leaves(params_from_jax(_np(jgrads), cfg, device="cpu", dtype=torch.float32))
    assert len(grads) == len(want)
    errs = [_normwise(g, w) for g, w in zip(grads, want)]
    assert all(g.dtype == torch.float32 for g in grads)
    assert max(errs) <= grad_tol, errs


@pytest.mark.parametrize("remat", ["none", "full", "dots"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_and_grads_match_jax(dtype, remat):
    """Reduced llama3.2-3b, every remat mode, f32 and bf16 compute."""
    _check_loss_and_grads("llama3.2-3b", dtype, remat)


@pytest.mark.parametrize("arch", DENSE[1:])
@pytest.mark.parametrize("remat", ["none", "full", "dots"])
def test_loss_and_grads_match_jax_every_dense_arch(arch, remat):
    """The other dense archs at reduced width: 2d-RoPE and kv 2 (chatglm),
    parallel blocks and LayerNorm (command-r), an untied unembedding
    (llama3-405b), QK-norm (chameleon)."""
    _check_loss_and_grads(arch, "float32", remat)


class _OpCounter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.counts = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.counts[func] = self.counts.get(func, 0) + 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("remat", ["none", "full", "dots"])
def test_remat_modes_recompute_what_they_say(remat):
    """Products re-run in the backward pass: none under ``"none"``, every
    layer's 2-D (``mm``) and batched (``bmm``) products under ``"full"``,
    only the batched ones (attention) under ``"dots"``."""
    _, cfg = _cfgs(n_layers=2)
    params = T.init(cfg, torch.Generator().manual_seed(0))
    live = [p.detach().requires_grad_(True) for p in leaves(params)]
    logits = T.forward(tree_unflatten(params, live), torch.from_numpy(_tokens(cfg)), cfg,
                       remat=remat)
    with _OpCounter() as c:
        torch.autograd.grad(logits.square().sum(), live)
    mm, bmm = torch.ops.aten.mm.default, torch.ops.aten.bmm.default
    # a layer's products: 7 mm (q, k, v, o, gate, up, down), 2 bmm (QK^T,
    # PV); the backward of each is two products, plus the logits' 2 mm.  A
    # recompute re-runs the products whose outputs the backward reads: all
    # but the down projection's, which only feeds the residual add
    recomputed = {"none": (0, 0), "full": (6, 2), "dots": (0, 2)}[remat]
    assert c.counts.get(mm, 0) == cfg.n_layers * (7 * 2 + recomputed[0]) + 2
    assert c.counts.get(bmm, 0) == cfg.n_layers * (2 * 2 + recomputed[1])


# ---------------------------------------------------------------------------
# train step
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("pkw,tol", [
    ({}, 1e-4), ({"grad_dtype": "float32", "remat": "none"}, 1e-4),
    # bf16 parameters: the two implementations round about 1% of them to
    # neighbouring bf16 values, one ulp (2**-8) apart, and the steps carry it
    ({"master_weights": True, "opt_state_dtype": "bfloat16"}, 2.0 ** -8)])
def test_train_trajectory_matches_jax(pkw, tol):
    """Five steps of ``make_train_step`` from JAX's initial state, f32
    compute: per-step loss, gradient norm and rate within 1e-4, parameters
    normwise within 1e-4 after the steps.  Variants: JAX's defaults (bf16
    grads, full remat), f32 grads, and bf16 parameters beside an f32 master
    copy with bf16 moments (held to one bf16 rounding throughout)."""
    jcfg, cfg = _cfgs()
    jp = jconfig.ParallelConfig(fsdp_params=False, **pkw)
    pcfg = ParallelConfig(fsdp_params=False, **pkw)
    jt = jconfig.TrainConfig(lr=3e-3, warmup_steps=2, total_steps=8)
    tcfg = TrainConfig(lr=3e-3, warmup_steps=2, total_steps=8)
    jstate = JS.init_train_state(jax.random.PRNGKey(0), jcfg, jp)
    state = train_state_from_jax(_np(jstate), cfg, device="cpu")
    assert state["opt"]["m"]["embed"]["embedding"].dtype == \
        (torch.bfloat16 if "opt_state_dtype" in pkw else torch.float32)
    jstep = jax.jit(JS.make_train_step(jcfg, jp, jt, None))
    step = S.make_train_step(cfg, pcfg, tcfg)
    for i in range(5):
        toks = _tokens(cfg, b=2, s=32, seed=100 + i)
        jstate, jm = jstep(jstate, {"tokens": jnp.asarray(toks)})
        state, m = step(state, {"tokens": torch.from_numpy(toks)})
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=tol)
        assert float(m["aux"]) == float(jm["aux"]) == 0.0
    assert int(state["opt"]["step"]) == int(jstate["opt"]["step"]) == 5
    want = train_state_from_jax(_np(jstate), cfg, device="cpu")
    pairs = list(zip(leaves(state["params"]), leaves(want["params"])))
    if "master_weights" in pkw:
        pairs += list(zip(leaves(state["opt"]["master"]), leaves(want["opt"]["master"])))
    for got_t, want_t in pairs:
        assert got_t.dtype == want_t.dtype
        assert _normwise(got_t, want_t) <= tol


def test_decay_mask_follows_the_stacked_layout():
    """JAX stacks each layer's leaves over the periods, so a layer's norm
    scale is 2-D there and AdamW decays it; the final norm's is 1-D and
    does not decay.  The port's unstacked layers keep JAX's rule."""
    _, cfg = _cfgs(n_layers=2)
    mask = T.decay_mask(T.init(cfg, None))
    assert mask["layers"][1]["ln1"]["scale"] and mask["layers"][0]["attn"]["wq"]
    assert not mask["final_norm"]["scale"] and mask["embed"]["embedding"]


def test_zero_step_without_ctx_warns_and_takes_the_single_device_step():
    _, cfg = _cfgs(n_layers=1)
    tcfg = TrainConfig(z_loss=0.0)
    batch = {"tokens": torch.from_numpy(_tokens(cfg))}
    with pytest.warns(UserWarning, match="reduce_scatter_zero"):
        zero = S.make_train_step(cfg, ParallelConfig(grad_reduce="reduce_scatter_zero"), tcfg)
    plain = S.make_train_step(cfg, ParallelConfig(), tcfg)
    gen = lambda: torch.Generator().manual_seed(0)
    s1, m1 = zero(S.init_train_state(gen(), cfg, ParallelConfig()), batch)
    s2, m2 = plain(S.init_train_state(gen(), cfg, ParallelConfig()), batch)
    assert float(m1["loss"]) == float(m2["loss"])
    assert all(torch.equal(a, b) for a, b in zip(leaves(s1), leaves(s2)))


def test_abstract_train_state_is_meta_with_the_init_structure():
    _, cfg = _cfgs(n_layers=1)
    pcfg = ParallelConfig(master_weights=True)
    real = S.init_train_state(torch.Generator().manual_seed(0), cfg, pcfg)
    abstract = S.abstract_train_state(cfg, pcfg)
    desc = lambda t: (tuple(t.shape), t.dtype)
    assert tree_map(desc, abstract) == tree_map(desc, real)
    assert all(t.device.type == "meta" for t in leaves(abstract))
    assert leaves(real["params"])[0].dtype == torch.bfloat16
    assert leaves(real["opt"]["master"])[0].dtype == torch.float32


def test_training_loss_decreases():
    """30 steps on the structured synthetic stream must cut the loss well
    below the start (the JAX package's ``test_training_loss_decreases``)."""
    cfg = configs.reduced(configs.get("llama3.2-3b")).replace(vocab=64)
    pcfg = ParallelConfig(remat="none", fsdp_params=False)
    tcfg = TrainConfig(lr=3e-3, warmup_steps=5, total_steps=40, z_loss=0.0)
    step = S.make_train_step(cfg, pcfg, tcfg)
    state = S.init_train_state(torch.Generator().manual_seed(0), cfg, pcfg)
    losses = []
    it = make_batch_iterator(cfg, ShapeConfig("t", "train", 64, 4), device="cpu")
    for _, batch in zip(range(30), it):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    it.close()
    assert losses[-1] < losses[0] - 0.5, losses[:3] + losses[-3:]


# ---------------------------------------------------------------------------
# recovery
# ---------------------------------------------------------------------------
def test_watchdog_detects_straggler():
    w = StepWatchdog(k=6.0, min_steps=5)
    jitter = np.random.RandomState(0)
    for _ in range(20):
        assert not w.observe(0.1 + jitter.rand() * 0.001)
    assert w.observe(1.0)


def test_elastic_plan_meshes():
    m = ElasticPlan(model=1).mesh_for(1)
    assert m.shape["model"] == 1 and m.shape["data"] == 1
    m = ElasticPlan(model=4).mesh_for(10, devices=list(range(10)))
    assert m.shape == {"data": 2, "model": 4} and m.devices == tuple(range(8))
    assert m.axis_names == ("data", "model")


def test_training_runner_recovers_from_fault(tmp_path):
    """Injected failure at step 7 -> restart from the step-5 checkpoint ->
    final state bitwise equal to an uninterrupted run (the JAX package's
    test, which holds it to 1e-5; on the CPU the port's is exact)."""
    cfg = configs.reduced(configs.get("llama3.2-3b")).replace(
        n_layers=1, d_model=32, n_heads=2, n_kv_heads=2, d_ff=64, vocab=64, head_dim=16)
    pcfg = ParallelConfig(remat="none", fsdp_params=False)
    tcfg = TrainConfig(lr=1e-3, warmup_steps=2, total_steps=10, z_loss=0.0)
    shape = ShapeConfig("t", "train", 32, 2)
    step = S.make_train_step(cfg, pcfg, tcfg)

    def make_build(ckdir):
        def build(start):
            if ckpt.latest_step(ckdir):
                state = ckpt.restore_checkpoint(ckdir, start, S.abstract_train_state(cfg, pcfg),
                                                device="cpu")
            else:
                state = S.init_train_state(torch.Generator().manual_seed(0), cfg, pcfg)
            return state, step, make_batch_iterator(cfg, shape, start_step=start,
                                                    device="cpu")
        return build

    d1, d2 = str(tmp_path / "faulty"), str(tmp_path / "clean")
    s1, h1 = TrainingRunner(directory=d1, build=make_build(d1), checkpoint_every=5).run(
        10, inject_fault_at=7)
    s2, h2 = TrainingRunner(directory=d2, build=make_build(d2), checkpoint_every=5).run(10)
    assert [h["step"] for h in h1] == list(range(7)) + [5, 6, 7, 8, 9]
    assert [h["step"] for h in h2] == list(range(10))
    assert all(torch.equal(a, b) for a, b in zip(leaves(s1), leaves(s2)))
    assert [h["loss"] for h in h1[-5:]] == [h["loss"] for h in h2[-5:]]


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------
def test_train_launcher_with_fault_injection(tmp_path):
    """The CLI launcher completes despite an injected node failure (the JAX
    package's ``test_train_launcher_with_fault_injection``, on the CPU)."""
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--arch", "chatglm3-6b", "--steps", "8", "--batch", "2", "--seq", "64",
         "--ckpt-every", "3", "--ckpt-dir", str(tmp_path / "ck"), "--inject-fault-at", "5"],
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")}, cwd=ROOT)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    assert "OK" in r.stdout.splitlines()
    assert ckpt.latest_step(str(tmp_path / "ck")) == 6


def test_launcher_refuses_what_it_cannot_do(tmp_path):
    """What a mesh ctx still refuses, before any collective: the
    sequence-parallel residual with ``dp_over_model`` (its spec would name
    ``model`` twice; JAX refuses it too); a model axis that does not divide
    the ranks; and the CPU unless asked.  A serve cache whose length the
    model axis does not split is held whole on every rank, as in JAX."""
    from repro_torch.core.mesh import AbstractMesh
    from repro_torch.parallel.sharding import make_ctx
    _, cfg = _cfgs(n_layers=1)
    params = T.init(cfg, torch.Generator().manual_seed(0))
    mesh = AbstractMesh((1, 2), ("data", "model"))
    ctx = make_ctx(mesh, ParallelConfig(fsdp_params=False))
    assert T.init_cache(cfg, 1, 7, device="cpu", ctx=ctx)[0][0].shape[1] == 7
    assert T.init_cache(cfg, 1, 8, device="cpu", ctx=ctx)[0][0].shape[1] == 4
    both = make_ctx(mesh, ParallelConfig(fsdp_params=False, sequence_parallel=True,
                                         dp_over_model=True))
    with pytest.raises(ValueError, match="sequence_parallel with dp_over_model"):
        T.forward(params, torch.zeros(1, 4, dtype=torch.int32), cfg, ctx=both)
    base = ["--device", "cpu", "--steps", "2", "--ckpt-dir", str(tmp_path / "ck")]
    with pytest.raises(ValueError, match="must divide"):
        launcher.main(base + ["--model-parallel", "2"])
    if torch.cuda.is_available():
        return
    # the default device is the card, and there is no fallback to the CPU
    with pytest.raises(RuntimeError, match="--device cpu"):
        launcher.main(["--steps", "2", "--ckpt-dir", str(tmp_path / "ck")])
    assert launcher.parse_args([]).device == "cuda"


def test_trainer_loads_no_jax():
    """The training path (launcher, steps, optimizer, data, checkpoints,
    runner, cost model) loads neither JAX nor the reference package."""
    code = ("import sys, repro_torch.launch.train, repro_torch.core.costmodel; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'repro')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")}, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
