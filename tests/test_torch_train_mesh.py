"""The port's trainer on a mesh of CPU ranks against the JAX package's
single-device trainer: the eight dense layouts, the ZeRO step, the sharded
init and the launcher with ``--ranks``.

JAX initialises the train state, ``repro_torch.convert`` carries it over,
and each rank keeps its blocks under ``train_state_shardings`` (the
reference's ``shard_params``).  The same numpy token batches go through
JAX's jitted single-device step and, split over the batch axes, through
the port's step on 4 ranks of the mesh (2, 2): every combination of FSDP
on / off, tensor parallelism or ``dp_over_model``, and the all-reduce or
the ZeRO step.  Three steps must follow JAX's trajectory (loss, gradient
norm and rate per step, the parameters normwise after the steps): f32
gradients to 1e-4, bf16 gradients to 2e-2, as
``test_torch_train.py::test_train_trajectory_matches_jax`` holds the
single-device step.  The ZeRO step must match the port's all-reduce step.

The sequence-parallel residual (``ParallelConfig(sequence_parallel=True)``:
the residual between the layers is each rank's S/2 rows) is held against
JAX's single-device ``forward`` and its gradients (of the logits against a
token-mean cotangent) on the same numpy inputs at
``tests/test_torch_tensor_ops.py``'s tolerances: the dense llama, an MoE
config, ``remat="full"`` and a no-grad forward (its attention through the
flash kernel's plain version); and the bytes its collectives staged equal
the count reckoned from the shapes.  All the port's runs share one
module-scoped launch.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro import config as jconfig
from repro import configs as jconfigs
from repro.launch.train import reduced as jreduced
from repro.models import transformer as JT
from repro.parallel import steps as JS
from repro_torch import checkpoint as ckpt
from repro_torch import configs
from repro_torch.config import ParallelConfig, TrainConfig
from repro_torch.convert import params_from_jax, train_state_from_jax
from repro_torch.core.mesh import P, AbstractMesh, assemble, launch, local_block
from repro_torch.launch import train as launcher
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.parallel import steps as S
from repro_torch.parallel.sharding import make_ctx, param_specs, shard_params
from repro_torch.tree import leaves, tree_map

MESH = (2, 2)
STEPS, BATCH, SEQ = 3, 4, 16
TOL = {"float32": 1e-4, "bfloat16": 2e-2}              # by gradient dtype
LAYOUTS = {f"{'fsdp' if f else 'nofsdp'}-{'dpom' if d else 'tp'}-{'zero' if z else 'ar'}":
           dict(fsdp_params=f, dp_over_model=d,
                grad_reduce="reduce_scatter_zero" if z else "all_reduce")
           for f in (False, True) for d in (False, True) for z in (False, True)}
# extra runs: the selective-recompute policy and the chunked loss under TP
EXTRA = {"fsdp-tp-ar-dots": dict(fsdp_params=True, remat="dots"),
         "nofsdp-tp-zero-chunk": dict(fsdp_params=False, grad_reduce="reduce_scatter_zero",
                                      logit_chunk=6)}
TCFG = dict(lr=3e-3, warmup_steps=2, total_steps=8)
SP_TOL = dict(rtol=1e-4, atol=1e-5)                     # tests/test_torch_tensor_ops.py
# sequence-parallel runs: (config, remat, gradients taken)
SP_CASES = {"dense": ("llama", "none", True), "moe": ("moe", "none", True),
            "remat_full": ("llama", "full", True), "no_grad": ("llama", "none", False)}


def _cfgs():
    return (jreduced(jconfigs.get("llama3.2-3b")).replace(dtype="float32", n_layers=2),
            configs.reduced(configs.get("llama3.2-3b")).replace(dtype="float32", n_layers=2))


def _tokens():
    r = np.random.RandomState(7)
    return [r.randint(0, 512, (BATCH, SEQ)).astype(np.int32) for _ in range(STEPS)]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _run(cfg, pcfg, tcfg, jstate, toks, mesh):
    """One layout on this rank: STEPS steps from JAX's state; per-step
    metrics and, on rank 0, the parameters assembled."""
    ctx = make_ctx(mesh, pcfg)
    full = train_state_from_jax(jstate, cfg, device="cpu")
    specs = S.train_state_shardings(cfg, pcfg, ctx, full)
    state = tree_map(lambda x, s: local_block(x, s, mesh).clone(), full, specs)
    assert all(torch.equal(a, b) for a, b in
               zip(leaves(state["params"]), leaves(shard_params(full["params"], cfg, ctx))))
    step = S.make_train_step(cfg, pcfg, tcfg, ctx)
    i, n = mesh.index(ctx.batch_axes), mesh.size(ctx.batch_axes)
    rows = BATCH // n
    metrics = []
    for t in toks:
        state, m = step(state, {"tokens": torch.from_numpy(t[i * rows:(i + 1) * rows])})
        metrics.append({k: float(v) for k, v in m.items()})
    params = [assemble(x, s, mesh) for x, s in zip(leaves(state["params"]),
                                                    leaves(specs["params"]))]
    return {"metrics": metrics, "params": params if mesh.rank == 0 else None}


def _sharded_init(cfg, mesh):
    """The port's own init on the ranks, assembled, for two layouts (ZeRO
    with FSDP and an f32 master copy; TP with all-reduce)."""
    out = {}
    for name, pcfg in {"zero-fsdp-master": ParallelConfig(
            fsdp_params=True, grad_reduce="reduce_scatter_zero", master_weights=True),
            "tp-ar": ParallelConfig(fsdp_params=False)}.items():
        ctx = make_ctx(mesh, pcfg)
        state = S.init_train_state(torch.Generator().manual_seed(3), cfg, pcfg, ctx)
        specs = S.train_state_shardings(cfg, pcfg, ctx, S.abstract_train_state(cfg, pcfg))
        # bf16 leaves widened (exactly): a result crosses to the test as numpy
        out[name] = [assemble(x, s, mesh).float() if x.dtype == torch.bfloat16 else
                     assemble(x, s, mesh) for x, s in zip(leaves(state), leaves(specs))]
    return out


def _sp_cfgs(name):
    """(JAX config, port config): the file's llama, or the reduced Mixtral
    (two ``attn_moe`` layers, 4 experts over the EP size 2: no capacity
    drops at these 32 tokens a rank)."""
    if name == "llama":
        return _cfgs()
    kw = dict(dtype="float32", n_layers=2)
    return (jreduced(jconfigs.get("mixtral-8x22b")).replace(**kw),
            configs.reduced(configs.get("mixtral-8x22b")).replace(**kw))


def _sp_run(name, remat, grad, jparams, toks, cot, mesh) -> dict:
    """One sequence-parallel forward (and backward of sum(logits * cot)) on
    this rank's rows and blocks: the logits and, summed over ``data``, the
    gradients assembled; the bytes staged by the forward and backward."""
    _, cfg = _sp_cfgs(name)
    ctx = make_ctx(mesh, ParallelConfig(fsdp_params=False, sequence_parallel=True))
    full = params_from_jax(jparams, cfg, device="cpu")
    specs = param_specs(full, cfg, ctx)
    params = tree_map(lambda x, s: local_block(x, s, mesh).clone().requires_grad_(grad), full,
                      specs)
    lspec = P("data", None, L.vocab_axis(cfg, ctx))
    rows = local_block(torch.from_numpy(toks), P("data"), mesh)
    staged = mesh.staged_bytes
    with mesh, torch.set_grad_enabled(grad):
        lg = T.forward(params, rows, cfg, ctx=ctx, remat=remat)
        if grad:
            (lg * local_block(torch.from_numpy(cot), lspec, mesh)).sum().backward()
    out = {"staged": mesh.staged_bytes - staged,
           "logits": assemble(lg.detach(), lspec, mesh), "grads": None}
    if grad:
        out["grads"] = [assemble(mesh.all_reduce(x.grad, "sum", "data"), s, mesh)
                        for x, s in zip(leaves(params), leaves(specs))]
    return out


def _ranks(device, jstates, toks, sp_inputs):
    _, cfg = _cfgs()
    mesh = make_local_mesh(2)
    tcfg = TrainConfig(**TCFG)
    res = {"sp": {case: _sp_run(name, remat, grad, sp_inputs[name], toks[0],
                                sp_inputs["cot"][name], mesh)
                  for case, (name, remat, grad) in SP_CASES.items()}}
    for gdt, jstate in jstates.items():
        for name, kw in LAYOUTS.items():
            res[(gdt, name)] = _run(cfg, ParallelConfig(grad_dtype=gdt, **kw), tcfg, jstate,
                                    toks, mesh)
    for name, kw in EXTRA.items():
        res[("float32", name)] = _run(cfg, ParallelConfig(grad_dtype="float32", **kw), tcfg,
                                      jstates["float32"], toks, mesh)
    res["init"] = _sharded_init(cfg, mesh)
    return res


def _jax_trajectory(jcfg, gdt, toks, **pkw):
    jp = jconfig.ParallelConfig(fsdp_params=False, grad_dtype=gdt, **pkw)
    jstate = JS.init_train_state(jax.random.PRNGKey(0), jcfg, jp)
    init = _np(jstate)
    jstep = jax.jit(JS.make_train_step(jcfg, jp, jconfig.TrainConfig(**TCFG), None))
    metrics = []
    for t in toks:
        jstate, m = jstep(jstate, {"tokens": jnp.asarray(t)})
        metrics.append({k: float(v) for k, v in m.items()})
    return init, metrics, _np(jstate)


def _jax_sp(toks):
    """JAX's single-device ``forward`` of each config and the gradients of
    sum(logits * cot): the parameters and cotangents (numpy) the ranks
    take, and the wanted logits and gradients."""
    inputs, want = {"cot": {}}, {}
    for name in ("llama", "moe"):
        jcfg, _ = _sp_cfgs(name)
        params = JT.init(jax.random.PRNGKey(1), jcfg)
        logits, vjp = jax.vjp(lambda p: JT.forward(p, jnp.asarray(toks), jcfg)[0], params)
        # the cotangent of a token mean, as a loss's is
        cot = (np.random.RandomState(3).randn(*logits.shape) / toks.size).astype(np.float32)
        inputs[name], inputs["cot"][name] = _np(params), cot
        want[name] = (np.asarray(logits), _np(vjp(jnp.asarray(cot))[0]))
    return inputs, want


@pytest.fixture(scope="module")
def runs():
    jcfg, _ = _cfgs()
    toks = _tokens()
    jax_runs = {gdt: _jax_trajectory(jcfg, gdt, toks) for gdt in ("float32", "bfloat16")}
    jax_runs["chunk"] = _jax_trajectory(jcfg, "float32", toks, logit_chunk=6)
    sp_inputs, jax_runs["sp"] = _jax_sp(toks[0])
    ranks = launch(4, _ranks, {g: jax_runs[g][0] for g in ("float32", "bfloat16")}, toks,
                   sp_inputs, device="cpu", timeout=600)
    return jax_runs, ranks[0]


def _normwise(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _check_trajectory(run, jax_run, tol):
    _, cfg = _cfgs()
    _, jmetrics, jfinal = jax_run
    for m, jm in zip(run["metrics"], jmetrics):
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(m[k], jm[k], rtol=tol)
        assert m["aux"] == jm["aux"] == 0.0
    want = leaves(train_state_from_jax(jfinal, cfg, device="cpu")["params"])
    assert len(run["params"]) == len(want)
    errs = [_normwise(g, w.numpy()) for g, w in zip(run["params"], want)]
    assert max(errs) <= tol, errs


@pytest.mark.parametrize("gdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_layout_follows_the_jax_trajectory(runs, layout, gdt):
    jax_runs, ranks = runs
    _check_trajectory(ranks[(gdt, layout)], jax_runs[gdt], TOL[gdt])


@pytest.mark.parametrize("name", list(EXTRA))
def test_dots_remat_and_chunked_loss_follow_the_jax_trajectory(runs, name):
    """Selective recompute (the collectives re-issued in the backward) and
    the sequence-chunked vocab-parallel loss."""
    jax_runs, ranks = runs
    want = jax_runs["chunk"] if "chunk" in name else jax_runs["float32"]
    _check_trajectory(ranks[("float32", name)], want, TOL["float32"])


@pytest.mark.parametrize("gdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", [k for k in LAYOUTS if k.endswith("-zero")])
def test_zero_step_matches_the_all_reduce_step(runs, layout, gdt):
    """The ZeRO step against the port's all-reduce step in the same layout:
    the same gradients, summed over the same ranks in another order (a
    reduce-scatter, then an all-reduce over the rest).  f32 gradients: the
    losses and norms agree to 1e-6, the parameters normwise to 1e-6; bf16
    gradients round each partial sum to bf16, so the parameters are held
    to one bf16 rounding (2**-8)."""
    _, ranks = runs
    zero, ar = ranks[(gdt, layout)], ranks[(gdt, layout[:-len("zero")] + "ar")]
    for m, n in zip(zero["metrics"], ar["metrics"]):
        np.testing.assert_allclose(m["loss"], n["loss"], rtol=1e-6)
        np.testing.assert_allclose(m["grad_norm"], n["grad_norm"], rtol=1e-6)
    bound = 1e-6 if gdt == "float32" else 2.0 ** -8
    assert max(_normwise(a, b) for a, b in zip(zero["params"], ar["params"])) <= bound


@pytest.mark.parametrize("name", ["zero-fsdp-master", "tp-ar"])
def test_sharded_init_equals_the_single_rank_init(runs, name):
    """Drawn leaf by leaf and cut to blocks at once, the state assembles to
    the single-rank ``init_train_state``, bit for bit."""
    _, ranks = runs
    _, cfg = _cfgs()
    pcfg = ParallelConfig(fsdp_params=True, grad_reduce="reduce_scatter_zero",
                          master_weights=True) if name != "tp-ar" else ParallelConfig()
    want = leaves(S.init_train_state(torch.Generator().manual_seed(3), cfg, pcfg))
    got = ranks["init"][name]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = w.float() if w.dtype == torch.bfloat16 else w
        np.testing.assert_array_equal(g, w.numpy())


@pytest.mark.parametrize("case", list(SP_CASES))
def test_sequence_parallel_matches_jax(runs, case):
    """The residual as each rank's S/2 rows (the Megatron sequence-parallel
    gathers and reduce-scatters; the MoE layer gathers the sequence and
    keeps its rows) on mesh (2, 2): the logits, and every gradient summed
    over ``data``, against JAX's single-device ``forward`` and ``jax.vjp``."""
    jax_runs, ranks = runs
    name, _, grad = SP_CASES[case]
    got = ranks["sp"][case]
    want_logits, want_grads = jax_runs["sp"][name]
    np.testing.assert_allclose(got["logits"], want_logits, **SP_TOL)
    if not grad:
        return
    _, cfg = _sp_cfgs(name)
    want = leaves(params_from_jax(want_grads, cfg, device="cpu", dtype=torch.float32))
    assert len(got["grads"]) == len(want)
    for g, w in zip(got["grads"], want):
        np.testing.assert_allclose(g, w.numpy(), **SP_TOL)


def _sp_staged_bytes(cfg, b: int, s: int, p: int) -> int:
    """The bytes one rank stages through the host (``core/mesh.py``: each
    collective's input copied out and its output copied in) for a
    sequence-parallel forward and backward of the dense model, f32, on
    its b rows with tensor parallelism p.  Every forward collective's
    transpose stages what it staged; the norm scales' gradients are
    all-reduced (``copy_d``)."""
    e, d = 4, cfg.d_model
    m = b * s * d * e                          # a whole (b, s, d) activation
    rows = m // p + m                          # gather the rows, or reduce-scatter onto them
    q = 2 * b * s * cfg.n_heads * cfg.hd * e // p          # one all-to-all of q or the output
    kv = b * s * cfg.n_kv_heads * cfg.hd * e * (p + 1) // p  # the k or the v all-gather
    layer = 4 * rows + 2 * q + 2 * kv          # in and out of attention and the MLP
    forward = cfg.n_layers * layer + 2 * rows  # the embedding's sum, the logits' gather
    return 2 * forward + (2 * cfg.n_layers + 1) * 2 * d * 4


def test_sequence_parallel_stages_the_bytes_reckoned_from_the_shapes(runs):
    _, ranks = runs
    _, cfg = _sp_cfgs("llama")
    assert L.vocab_axis(cfg, make_ctx(AbstractMesh(MESH, ("data", "model")),
                                      ParallelConfig(fsdp_params=False))) == "model"
    want = _sp_staged_bytes(cfg, BATCH // MESH[0], SEQ, MESH[1])
    assert ranks["sp"]["dense"]["staged"] == want
    # the same forward without its backward stages half of the collectives'
    assert ranks["sp"]["no_grad"]["staged"] == (want - (2 * cfg.n_layers + 1) * 8 *
                                                cfg.d_model) // 2


def test_launcher_on_four_ranks_recovers_and_its_checkpoint_restores_anywhere(tmp_path,
                                                                             capsys):
    """``--ranks 4 --model-parallel 2 --plan auto --steps 8 --ckpt-every 3
    --inject-fault-at 5`` prints the picked plan and OK.  Its step-6
    checkpoint restores on one rank (the same leaves through JAX's
    ``restore_checkpoint``), and one rank resuming from it reaches the four
    ranks' final state."""
    d = str(tmp_path / "ck")
    argv = ["--device", "cpu", "--ranks", "4", "--model-parallel", "2", "--plan", "auto",
            "--steps", "8", "--ckpt-every", "3", "--ckpt-dir", d]
    states, history = launcher.main(argv + ["--inject-fault-at", "5"])
    lines = capsys.readouterr().out.splitlines()
    assert "OK" in lines and any(ln.startswith("plan_search picked:") for ln in lines)
    # the fault at step 5 restarts every rank from the step-3 checkpoint; a
    # straggler verdict under a loaded host may restart once more later
    steps = [h["step"] for h in history]
    assert steps[:7] == [0, 1, 2, 3, 4, 3, 4] and steps[-1] == 7
    assert ckpt.latest_step(d) == 6

    job = launcher.make_job(launcher.parse_args(argv))
    cfg, pcfg = job.cfg, job.pcfg
    like = S.abstract_train_state(cfg, pcfg)
    one = ckpt.restore_checkpoint(d, 6, like, device="cpu")
    jtree = jckpt.restore_checkpoint(d, 6, jax.tree.map(
        lambda t: np.zeros(t.shape, np.float32), like, is_leaf=torch.is_tensor))
    for a, b in zip(jax.tree.leaves(jtree), leaves(one)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())

    # one rank resumes the four ranks' run from step 6 and ends where they did
    out = launcher.train_rank("cpu", job)
    assert [h["step"] for h in out["history"]] == [6, 7]
    ctx = make_ctx(AbstractMesh((2, 2), ("data", "model")), pcfg)
    specs = S.train_state_shardings(cfg, pcfg, ctx, like)
    for rank, blocks in enumerate(states):
        coords = dict(zip(("data", "model"), np.unravel_index(rank, (2, 2))))
        for spec, full, got in zip(leaves(specs), leaves(out["state"]), leaves(blocks)):
            want = full.float().numpy()
            for dim, part in enumerate(spec):
                axes = () if part is None else (part if isinstance(part, tuple) else (part,))
                idx, n = 0, 1
                for a in axes:
                    idx, n = idx * 2 + int(coords[a]), n * 2
                blk = want.shape[dim] // n
                want = np.take(want, range(idx * blk, (idx + 1) * blk), axis=dim)
            # bf16 compute: the ranks and the one process sum in other orders
            assert _normwise(got, want) <= 2e-2 if want.any() else not got.any()
